"""PyTorch port vs the JAX package: the column-slab tier (ops/slab.py)
and the loader's `symbolic_spgemm`, as in tests/test_slab.py.  The same
numpy-built inputs go through both packages on the CPU: plans, ids and
counters exactly equal, payloads within 1e-5 of max|C| at "highest" and
2e-3 at "default"."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops import slab as jslab
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.runtime import native as jnative
from hierarchical_block_sparse_lib_tpu.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.ops import slab as tslab
from hierarchical_block_sparse_lib_tpu_torch.runtime import native as tnative

from torch_port_helpers import (
    assert_same_info,
    assert_same_plan,
    bf16_rounded,
    np_,
    rel_to_max,
    to_port,
)

TOL = {"highest": 1e-5, "default": 2e-3}


def _near_dense(n, b, density, seed):
    rng = np.random.default_rng(seed)
    nb = n // b
    d = rng.standard_normal((n, n)).astype(np.float32)
    mask = np.kron(rng.random((nb, nb)) < density, np.ones((b, b), bool))
    return np.where(mask, d, 0).astype(np.float32)


def _pair(d, b):
    jm = jx.from_dense(d, block_size=b)
    return jm, to_port(jm)


def _check(ja, jb, ta, tb, precision="highest", **kw):
    """The colslab product in both packages: plan, ids, counters exactly,
    payload within the tier's tolerance."""
    jc, ji = jx.spgemm_colslab(ja, jb, precision=precision, **kw)
    tc, ti = tx.spgemm_colslab(ta, tb, precision=precision, **kw)
    np.testing.assert_array_equal(np_(tc.ids), np.asarray(jc.ids))
    assert int(tc.nnz) == int(jc.nnz)
    assert rel_to_max(np_(tc.data), np.asarray(jc.data)) <= TOL[precision]
    assert_same_info(ti, ji)
    return tc, ti


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_colslab_matches_jax_and_oracle(n_slabs):
    n, b = 256, 16
    dA, dB = _near_dense(n, b, 0.5, seed=1), _near_dense(n, b, 0.5, seed=2)
    (ja, ta), (jb, tb) = _pair(dA, b), _pair(dB, b)
    assert_same_plan(tslab.plan_colslab(ta, tb, n_slabs), jslab.plan_colslab(ja, jb, n_slabs))
    tc, ti = _check(ja, jb, ta, tb, n_slabs=n_slabs, alpha=0.5)
    np.testing.assert_allclose(
        tx.to_dense(tc).numpy(), 0.5 * dA @ dB, rtol=2e-4, atol=1e-2
    )
    pc, oc = plan_spgemm(ja, jb)
    assert (int(ti.n_block_pairs), int(ti.n_out_blocks), int(tc.nnz)) == (pc, oc, oc)
    assert not bool(ti.pair_overflow | ti.out_overflow | ti.row_overflow)


@pytest.mark.parametrize("b", [16, 128])
def test_colslab_default_tier(b):
    """"default" at the fine leaf and at the row-panel kernel's leaf.  The
    port's kernels (here their plain versions) round the operands to bf16
    at "default", as the TPU's matrix unit does and JAX's CPU dots do not:
    JAX is handed the rounded operands, so both sum exact products."""
    n = 384 if b == 128 else 256
    dA = _near_dense(n, b, 0.6, seed=4)
    ja, _ = _pair(bf16_rounded(dA), b)
    _, ta = _pair(dA, b)
    _check(ja, ja, ta, ta, precision="default", n_slabs=3)


def test_colslab_with_plan():
    """A plan from `plan_colslab` reused: the same product as `n_slabs`."""
    n, b = 256, 16
    ja, ta = _pair(_near_dense(n, b, 0.6, seed=4), b)
    plan = tslab.plan_colslab(ta, ta, 3)
    assert_same_plan(plan, jslab.plan_colslab(ja, ja, 3))
    c1, i1 = tx.spgemm_colslab(ta, ta, plan=plan)
    c2, _ = tx.spgemm_colslab(ta, ta, n_slabs=3)
    assert torch.equal(c1.ids, c2.ids) and torch.equal(c1.data, c2.data)
    assert int(i1.n_block_pairs) == plan.total_pairs
    with pytest.raises(ValueError, match="n_slabs"):
        tx.spgemm_colslab(ta, ta)


def test_colslab_sparse_and_empty_slabs():
    """Banded input where some slabs carry nothing."""
    n, b = 256, 16
    r, c, v = gen.banded_coo(n, 12, seed=3)
    dA = gen.dense_oracle(r, c, v, n)
    ja, ta = _pair(dA, b)
    assert_same_plan(tslab.plan_colslab(ta, ta, 8), jslab.plan_colslab(ja, ja, 8))
    tc, ti = _check(ja, ja, ta, ta, n_slabs=8)
    np.testing.assert_allclose(tx.to_dense(tc).numpy(), dA @ dA, rtol=2e-4, atol=1e-2)


def test_colslab_empty_product():
    """No pair at all: the empty plan and an empty result in both."""
    n, b = 128, 16
    dA = np.zeros((n, n), np.float32)
    dA[:16, :16] = 1.0  # block (0, 0)
    dB = np.zeros((n, n), np.float32)
    dB[32:48, :16] = 1.0  # block (2, 0): no k meets A's column 0
    (ja, ta), (jb, tb) = _pair(dA, b), _pair(dB, b)
    plan = tslab.plan_colslab(ta, tb, 2)
    assert_same_plan(plan, jslab.plan_colslab(ja, jb, 2))
    assert plan.n_out == 0 and plan.slabs == ()
    tc, _ = _check(ja, jb, ta, tb, n_slabs=2)
    assert tc.cap == 1 and int(tc.nnz) == 0


def test_plan_colslab_numpy_fallback(monkeypatch):
    """Without the native library the slab output ids come from the numpy
    path: the same plan as the native one."""
    n, b = 256, 16
    _, ta = _pair(_near_dense(n, b, 0.4, seed=7), b)
    assert tnative.have_native()
    native_plan = tslab.plan_colslab(ta, ta, 3)
    monkeypatch.setattr(tnative, "have_native", lambda: False)
    assert_same_plan(tslab.plan_colslab(ta, ta, 3), native_plan)


@pytest.mark.parametrize("cut", [0, 7])
def test_symbolic_spgemm_matches_jax(cut):
    """The loader's full host symbolic phase equals the JAX package's,
    with room for every pair and with `cut` pairs short of it."""
    rng = np.random.default_rng(5)
    nbr, nbk, nbc = 9, 11, 7
    a_ids = np.sort(rng.choice(nbr * nbk, 40, replace=False)).astype(np.int32)
    b_ids = np.sort(rng.choice(nbk * nbc, 30, replace=False)).astype(np.int32)
    a_ids = np.concatenate([a_ids, np.full(3, np.iinfo(np.int32).max, np.int32)])
    total = tnative.plan_spgemm(a_ids, b_ids, nbk, nbk, nbc)[0]
    got = tnative.symbolic_spgemm(a_ids, b_ids, nbk, nbc, total - cut)
    want = jnative.symbolic_spgemm(a_ids, b_ids, nbk, nbc, total - cut)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[3] == total
