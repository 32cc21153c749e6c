"""PyTorch port vs the JAX package: leaf-strip packing SpGEMM
(ops/leafpack.py), as in tests/test_leafpack.py.  The same numpy-built
inputs go through both packages on the CPU: every plan table and count
exactly equal, C's ids and counters exactly, payloads within 1e-5 of
max|C| at "highest" and 2e-3 at "default"."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops import leafpack as jlp
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.ops import leafpack as tlp

from torch_port_helpers import (
    assert_same_info,
    assert_same_plan,
    np_,
    rel_to_max,
    to_port,
)

TOL = {"highest": 1e-5, "default": 2e-3}


def _check(ja, jb, dA, dB, strip_rows=128, alpha=1.0, precision="highest"):
    """Plans equal, the product in both packages, the oracle and the fine
    pair enumeration's counters and ids."""
    ta, tb = to_port(ja), to_port(jb)
    jplan = jlp.plan_leafpack(ja, jb, strip_rows=strip_rows)
    tplan = tlp.plan_leafpack(ta, tb, strip_rows=strip_rows)
    assert tplan is not None
    assert_same_plan(tplan, jplan)
    assert tplan.inflation == jplan.inflation
    jc, ji = jlp.leafpack_spgemm(ja, jb, jplan, alpha=alpha, precision=precision)
    tc, ti = tlp.leafpack_spgemm(ta, tb, tplan, alpha=alpha, precision=precision)
    np.testing.assert_array_equal(np_(tc.ids), np.asarray(jc.ids))
    assert int(tc.nnz) == int(jc.nnz)
    assert rel_to_max(np_(tc.data), np.asarray(jc.data)) <= TOL[precision]
    assert_same_info(ti, ji)
    assert not bool(ti.plan_mismatch)
    np.testing.assert_allclose(tx.to_dense(tc).numpy(), alpha * (dA @ dB), rtol=2e-4, atol=1e-3)
    n_pairs, n_out = plan_spgemm(ja, jb)
    assert int(ti.n_leaf_multiplies) == n_pairs and int(ti.n_out_blocks) == n_out
    return tplan


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_banded_leafpack(precision):
    """Scaled-down B1 (same bandwidth and leaf): banded at leaf 16."""
    n, bw, b = 1024, 64, 16
    r, c, v = gen.banded_coo(n, bw, seed=0)
    dA = gen.dense_oracle(r, c, v, n)
    ja = jx.from_coo(r, c, v, n, block_size=b)
    plan = _check(ja, ja, dA, dA, precision=precision)
    assert plan.inflation < 5.5


def test_banded_alpha_and_strips():
    n, bw, b = 384, 16, 16
    r, c, v = gen.banded_coo(n, bw, seed=1)
    dA = gen.dense_oracle(r, c, v, n)
    ja = jx.from_coo(r, c, v, n, block_size=b)
    _check(ja, ja, dA, dA, strip_rows=64, alpha=-0.5)


def test_random_local_leafpack():
    """Random block-sparse with strip-local support (leaf 32)."""
    n, b = 512, 32
    rng = np.random.default_rng(7)
    nb = n // b
    rows, cols, vals = [], [], []
    for br in range(nb):
        for bc in rng.choice(nb, size=5, replace=False):
            rows.append(np.repeat(np.arange(b), b) + br * b)
            cols.append(np.tile(np.arange(b), b) + bc * b)
            vals.append(rng.standard_normal(b * b).astype(np.float32))
    r, c, v = (np.concatenate(x) for x in (rows, cols, vals))
    dA = gen.dense_oracle(r, c, v, n)
    ja = jx.from_coo(r.astype(np.int32), c.astype(np.int32), v, n, block_size=b)
    _check(ja, ja, dA, dA)


def test_rectangular_leafpack():
    """A[256x384] @ B[384x128] at leaf 16: distinct block grids."""
    b = 16
    rng = np.random.default_rng(3)
    dA = np.zeros((256, 384), np.float32)
    dB = np.zeros((384, 128), np.float32)
    for i in range(0, 256, b):
        for j in range(i, min(i + 3 * b, 384), b):
            dA[i : i + b, j : j + b] = rng.standard_normal((b, b))
    for i in range(0, 384, b):
        for j in range(0, 128, b):
            if rng.random() < 0.4:
                dB[i : i + b, j : j + b] = rng.standard_normal((b, b))
    ra, ca = np.nonzero(dA)
    rb, cb = np.nonzero(dB)
    ja = jx.from_coo(ra, ca, dA[ra, ca], 256, n_cols=384, block_size=b)
    jb = jx.from_coo(rb, cb, dB[rb, cb], 384, n_cols=128, block_size=b)
    _check(ja, jb, dA, dB)


def test_leafpack_guard_and_mismatch():
    n, bw, b = 256, 16, 16
    r, c, v = gen.banded_coo(n, bw, seed=2)
    ja = jx.from_coo(r, c, v, n, block_size=b)
    ta = to_port(ja)
    # Applicability guard: a too-tight max_cols gives no plan in both.
    assert tlp.plan_leafpack(ta, ta, max_cols=1) is None
    assert jlp.plan_leafpack(ja, ja, max_cols=1) is None
    plan = tlp.plan_leafpack(ta, ta)
    # A stale plan (another structure at the same capacity) is loud.
    r2, c2, v2 = gen.banded_coo(n, 32, seed=2)
    a2 = tx.repack(tx.from_coo(r2, c2, v2, n, block_size=b, device="cpu"), ta.cap)
    _, info = tlp.leafpack_spgemm(a2, a2, plan)
    assert bool(info.plan_mismatch)
    _, info = tlp.leafpack_spgemm(ta, ta, plan)
    assert not bool(info.plan_mismatch)
