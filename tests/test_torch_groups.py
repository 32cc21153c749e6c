"""PyTorch port vs the JAX package: the row-group backend
(kernels/pallas_gemm_groups.py: `plan_groups`, `groups_spgemm`, and
`spgemm(backend="groups")` with its group-capacity check), as in
tests/test_pallas_kernels.py.  Plans are compared field for field, ids
and counters exactly, payloads within 1e-5 of max|C|.  The JAX kernel
runs in interpret mode; on the CPU the port takes its plain version."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.kernels.pallas_gemm_groups import (
    groups_spgemm as jax_groups_spgemm,
)
from hierarchical_block_sparse_lib_tpu.kernels.pallas_gemm_groups import (
    plan_groups as jax_plan_groups,
)
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_groups as pg

from torch_port_helpers import assert_same_info, assert_same_matrix, to_port

B = 128


def banded_ids(nbr, nbc, hw):
    """Row-major ids of a band of half-width hw on an nbr x nbc grid."""
    return np.array([i * nbc + j for i in range(nbr)
                     for j in range(max(0, i - hw), min(nbc, i + hw + 1))], np.int32)


def structure(ids, nbr, nbc, dtype=torch.float32):
    """An id structure with the attributes `plan_groups` reads, in either
    package's form: (JAX view, port view)."""
    geo = dict(nb_rows=nbr, nb_cols=nbc, block_size=B)
    jview = types.SimpleNamespace(ids=jnp.asarray(ids), dtype=jnp.float32, **geo)
    tview = types.SimpleNamespace(ids=torch.from_numpy(ids), dtype=dtype, **geo)
    return jview, tview


def banded_pair(nb, hw, seed, nbc=None, bf16=False):
    """(JAX, port) BlockMatrix of a random band at leaf 128, f32 or (both
    rounded to nearest) bf16."""
    nbc = nb if nbc is None else nbc
    ids = banded_ids(nb, nbc, hw)
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((ids.size, B, B)).astype(np.float32)
    jm = jx.BlockMatrix(ids=jnp.asarray(ids), data=jnp.asarray(data),
                        nnz=jnp.asarray(ids.size, jnp.int32),
                        n_rows=nb * B, n_cols=nbc * B, block_size=B)
    tm = to_port(jm)
    if bf16:
        jm = jm.with_data(jm.data.astype(jnp.bfloat16))
        tm = tm.with_data(tm.data.to(torch.bfloat16))
    return jm, tm


def same(tc, ti, jc, ji):
    assert_same_info(ti, ji)
    scale = float(np.abs(np.asarray(jc.data, np.float32)).max())
    assert_same_matrix(tc, jc, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("nb,hw", [(21, 2), (16, 1), (24, 3)])
def test_plan_groups_matches_jax(nb, hw):
    """Every field of the plan, for the default preference and for each G
    alone (a partial last group at nb=21)."""
    jview, tview = structure(banded_ids(nb, nb, hw), nb, nb)
    for prefer in [(16, 8, 4, 2, 1), (16,), (8,), (4,), (2,), (1,)]:
        want = jax_plan_groups(jview, jview, prefer=prefer)
        got = tx.plan_groups(tview, tview, prefer=prefer)
        assert (got is None) == (want is None), prefer
        if want is not None:
            assert got.__dict__ == want.__dict__, (prefer, got, want)
            assert got.caps == want.caps and got.reuse == want.reuse
    assert tx.plan_groups(tview, tview).reuse > 1.5


def test_plan_groups_rejects_nonlocal():
    """A scattered structure: the slabs approach all of B, no G fits the
    reference's rule, and both planners return None."""
    rng = np.random.default_rng(3)
    nb = 64
    ids = np.sort(rng.choice(nb * nb, nb * nb // 2, replace=False)).astype(np.int32)
    jview, tview = structure(ids, nb, nb)
    assert jax_plan_groups(jview, jview) is None
    assert tx.plan_groups(tview, tview) is None
    # float64 data never gets a group plan (the kernels accumulate in f32).
    jview, tview = structure(banded_ids(8, 8, 1), 8, 8, dtype=torch.float64)
    assert tx.plan_groups(tview, tview) is None


def test_groups_spgemm_matches_jax_interpret():
    """The kernel module at the smallest banded case against the JAX
    kernel in interpret mode, with two tail slots."""
    ja, ta = banded_pair(16, 1, 5)
    plan = jax_plan_groups(ja, ja)
    pc, oc = plan_spgemm(ja, ja)
    out_ids = jx.spgemm_symbolic(ja, ja, pc)[2]
    out_ids = jnp.concatenate([jnp.unique(out_ids), jnp.full((2,), 2**31 - 1, jnp.int32)])
    args = (16, 16, 16, oc + 2, *plan.caps)
    want = np.asarray(jax_groups_spgemm(ja.ids, ja.data, ja.ids, ja.data, out_ids, *args))
    got = pg.groups_spgemm(ta.ids, ta.data, ta.ids, ta.data,
                           torch.from_numpy(np.array(out_ids)), *args).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert not got[oc:].any()


@pytest.mark.parametrize("nb,hw", [(21, 2), (16, 1)])
def test_groups_backend_banded_matches_jax(nb, hw):
    """spgemm on the groups backend against the JAX package's product
    (its "xla" path: the interpret-mode kernel is held above), with the
    partial last group of nb=21 and the group check clear."""
    ja, ta = banded_pair(nb, hw, nb)
    plan = tx.plan_groups(ta, ta)
    assert nb % plan.g == (5 if nb == 21 else 0)  # a partial last group at nb=21
    pc, oc = plan_spgemm(ja, ja)
    jc, ji = jx.spgemm(ja, ja, pc, oc, backend="xla")
    tc, ti = tx.spgemm(ta, ta, pc, oc, backend="groups", group_caps=plan.caps)
    same(tc, ti, jc, ji)
    assert not bool(ti.row_overflow)


def test_groups_rectangular_matches_jax():
    """A rectangular product (7x5 by 5x9 blocks): a mix-up of A's rows,
    B's rows and B's columns in the group tables would show."""
    ja, ta = banded_pair(7, 1, 11, nbc=5)
    jb, tb = banded_pair(5, 2, 12, nbc=9)
    plan = tx.plan_groups(ta, tb, prefer=(4,))
    assert plan.caps == jax_plan_groups(ja, jb, prefer=(4,)).caps
    pc, oc = plan_spgemm(ja, jb)
    jc, ji = jx.spgemm(ja, jb, pc, oc + 3, backend="xla", alpha=0.5)
    tc, ti = tx.spgemm(ta, tb, pc, oc + 3, backend="groups", group_caps=plan.caps, alpha=0.5)
    same(tc, ti, jc, ji)


def test_groups_accum_union_matches_jax():
    """Fused accumulate: a union slot no product reaches comes out zero
    from the kernel, so beta*D lands on a clean slot."""
    ja, ta = banded_pair(16, 1, 9)
    rng = np.random.default_rng(9)
    d_ids = np.array([15, 17], np.int32)  # (0, 15) is off the product's support
    d_data = rng.standard_normal((2, B, B)).astype(np.float32)
    jd = jx.BlockMatrix(ids=jnp.asarray(d_ids), data=jnp.asarray(d_data),
                        nnz=jnp.asarray(2, jnp.int32), n_rows=16 * B, n_cols=16 * B,
                        block_size=B)
    plan = tx.plan_groups(ta, ta)
    pc, oc = plan_spgemm(ja, ja)
    jc, ji = jx.spgemm(ja, ja, pc, oc + 2, backend="xla", accum=jd, beta=0.5)
    tc, ti = tx.spgemm(ta, ta, pc, oc + 2, backend="groups", group_caps=plan.caps,
                       accum=to_port(jd), beta=0.5)
    same(tc, ti, jc, ji)
    slot = int(np.searchsorted(tc.ids.numpy(), 15))
    np.testing.assert_array_equal(tc.data[slot].numpy(), 0.5 * d_data[0])


def test_groups_overflow_flagged():
    """A slab cap below the true maximum sets row_overflow (never silent);
    the ids still equal the JAX package's."""
    ja, ta = banded_pair(16, 2, 13)
    plan = tx.plan_groups(ta, ta)
    g, am, sm, cm = plan.caps
    assert sm > 8
    pc, oc = plan_spgemm(ja, ja)
    tc, ti = tx.spgemm(ta, ta, pc, oc, backend="groups", group_caps=(g, am, 8, cm))
    assert bool(ti.row_overflow)
    jc, _ = jx.spgemm(ja, ja, pc, oc, backend="xla")
    np.testing.assert_array_equal(tc.ids.numpy(), np.asarray(jc.ids))
    for caps in ((g, 8, sm, cm), (g, am, sm, 8)):  # the A and C group caps
        assert bool(tx.spgemm(ta, ta, pc, oc, backend="groups", group_caps=caps)[1].row_overflow)


def test_groups_bf16_and_high_precision():
    """bf16 storage (one exact pass: equal to the JAX package's product of
    the same bf16 operands) and f32 "high" (the bf16x3 split: better than
    one bf16 pass, worse than full f32, against an f64 oracle)."""
    ja, ta = banded_pair(12, 1, 13)
    plan = tx.plan_groups(ta, ta)
    pc, oc = plan_spgemm(ja, ja)
    d = tx.to_dense(ta).double()
    ref = d @ d
    tc, _ = tx.spgemm(ta, ta, pc, oc, backend="groups", group_caps=plan.caps, precision="high")
    err_high = float((tx.to_dense(tc).double() - ref).abs().max() / ref.abs().max())
    assert 1e-8 < err_high < 2e-5, err_high
    jb16, tb16 = banded_pair(12, 1, 13, bf16=True)
    jc, ji = jx.spgemm(jb16, jb16, pc, oc, backend="xla")
    tc, ti = tx.spgemm(tb16, tb16, pc, oc, backend="groups", group_caps=plan.caps)
    assert tc.dtype == torch.bfloat16
    # Both round the f32 sums to bf16: they may differ by one bf16 unit,
    # and by f32 summation order near zero.
    assert_same_info(ti, ji)
    want = jc.with_data(jc.data.astype(jnp.float32))
    assert_same_matrix(tc.with_data(tc.data.float()), want, rtol=2.0**-7,
                       atol=1e-5 * float(np.abs(np.asarray(want.data)).max()))
