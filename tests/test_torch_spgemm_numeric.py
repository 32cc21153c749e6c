"""PyTorch port vs the JAX package: `spgemm` itself (ops/spgemm.py) on
each ported backend, with transpose flags, the fused accumulate with
tensor alpha/beta, plans and their self-check, and every overflow flag.
JAX gets an explicit backend: on the CPU its "auto" would take the
stream kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex

from torch_port_helpers import assert_same_info, assert_same_matrix, matrix_pair


def operands(b=16, ta=False, tb=False):
    """Rectangular A (6x8 blocks, an empty row, padding) and B (8x5),
    stored transposed where the flag asks for it."""
    ja, xa = matrix_pair(8, 6, b, 0.35, 31, pad=1) if ta else matrix_pair(
        6, 8, b, 0.35, 31, empty_rows=(1,), pad=1)
    jb, xb = matrix_pair(5, 8, b, 0.35, 32) if tb else matrix_pair(8, 5, b, 0.35, 32)
    return ja, xa, jb, xb


def caps(ja, jb, ta=False, tb=False):
    return plan_spgemm_ex(jx.transpose(ja) if ta else ja, jx.transpose(jb) if tb else jb)


def same(tc, ti, jc, ji):
    assert_same_info(ti, ji)
    scale = float(np.abs(np.asarray(jc.data)).max())
    assert_same_matrix(tc, jc, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("backend,ta,tb", [
    ("xla", False, False), ("rows", True, False), ("fine", False, True),
])
def test_spgemm_matches_jax(backend, ta, tb):
    ja, xa, jb, xb = operands(ta=ta, tb=tb)
    pc, oc, mbr, mcr = caps(ja, jb, ta, tb)
    kw = dict(transpose_a=ta, transpose_b=tb, row_caps=(mbr, mcr), alpha=0.5)
    jc, ji = jx.spgemm(ja, jb, pc + 3, oc + 2, backend=backend, **kw)
    tc, ti = tx.spgemm(xa, xb, pc + 3, oc + 2, backend=backend, **kw)
    same(tc, ti, jc, ji)
    assert not tc.data[oc:].any()  # zero padding


@pytest.mark.parametrize("backend", ["xla", "rows"])
def test_spgemm_accum_tensor_scalars_match_jax(backend):
    """C = alpha*A@B + beta*D over the union support, with alpha and beta
    0-dim tensors (as sp2_step passes them)."""
    ja, xa, jb, xb = operands()
    jd, xd = matrix_pair(6, 5, 16, 0.4, 33, pad=2)
    pc, oc, mbr, mcr = caps(ja, jb)
    out_cap = oc + int(jd.nnz) + 3
    jc, ji = jx.spgemm(ja, jb, pc, out_cap, backend=backend, row_caps=(mbr, mcr),
                       alpha=jnp.float32(-1.5), accum=jd, beta=jnp.float32(0.75))
    tc, ti = tx.spgemm(xa, xb, pc, out_cap, backend=backend, row_caps=(mbr, mcr),
                       alpha=torch.tensor(-1.5), accum=xd, beta=torch.tensor(0.75))
    same(tc, ti, jc, ji)
    assert int(ti.n_out_blocks) > oc  # the union is wider than the product


def test_planned_spgemm_and_stale_plan_match_jax():
    ja, xa, jb, xb = operands()
    jd, xd = matrix_pair(6, 5, 16, 0.4, 34, pad=2)
    pc, oc, mbr, mcr = caps(ja, jb)
    out_cap = oc + int(jd.nnz)
    kw = dict(backend="rows", row_caps=(mbr, mcr), beta=-2.0)
    jplan = jx.make_plan(ja, jb, pc, accum_ids=jd.ids, out_cap=out_cap)
    tplan = tx.make_plan(xa, xb, pc, accum_ids=xd.ids, out_cap=out_cap)
    jc, ji = jx.spgemm(ja, jb, pc, out_cap, accum=jd, plan=jplan, **kw)
    tc, ti = tx.spgemm(xa, xb, pc, out_cap, accum=xd, plan=tplan, **kw)
    same(tc, ti, jc, ji)
    tu, _ = tx.spgemm(xa, xb, pc, out_cap, accum=xd, **kw)
    assert torch.equal(tu.data, tc.data) and not bool(ti.plan_mismatch)
    # A stale plan (B's structure changed) is reported, never silent.
    jb2, xb2 = matrix_pair(8, 5, 16, 0.35, 35)
    jc, ji = jx.spgemm(ja, jb2, pc, out_cap, accum=jd, plan=jplan, **kw)
    tc, ti = tx.spgemm(xa, xb2, pc, out_cap, accum=xd, plan=tplan, **kw)
    assert bool(ti.plan_mismatch) and bool(ji.plan_mismatch)
    assert_same_info(ti, ji)


@pytest.mark.parametrize("case", ["row_caps", "pair_cap", "out_cap"])
def test_overflow_flags_match_jax(case):
    ja, xa, jb, xb = operands()
    pc, oc, mbr, mcr = caps(ja, jb)
    rc, backend = (mbr, mcr), "xla"
    if case == "row_caps":
        rc, backend = (1, 1), "rows"  # bucketed to 8 < the true maxima
        ja, xa = matrix_pair(4, 4, 16, 1.0, 36)
        jb, xb = matrix_pair(4, 12, 16, 1.0, 37)
        pc, oc, _, _ = caps(ja, jb)
    elif case == "pair_cap":
        pc = pc // 2
    else:
        oc = oc // 2
    jc, ji = jx.spgemm(ja, jb, pc, oc, backend=backend, row_caps=rc)
    tc, ti = tx.spgemm(xa, xb, pc, oc, backend=backend, row_caps=rc)
    assert_same_info(ti, ji)
    flag = {"row_caps": "row_overflow", "pair_cap": "pair_overflow",
            "out_cap": "out_overflow"}[case]
    assert bool(getattr(ti, flag))
    np.testing.assert_array_equal(tc.ids.numpy(), np.asarray(jc.ids))


def test_spgemm_b128_auto_matches_jax_rows():
    """At 128-wide leaves with row caps the port's "auto" takes the
    row-panel kernel module, as the reference does on its accelerator."""
    ja, xa = matrix_pair(3, 4, 128, 0.5, 38, pad=1)
    jb, xb = matrix_pair(4, 3, 128, 0.5, 39)
    jd, xd = matrix_pair(3, 3, 128, 0.5, 40)
    pc, oc, mbr, mcr = caps(ja, jb)
    kw = dict(row_caps=(mbr, mcr), beta=0.5)
    jc, ji = jx.spgemm(ja, jb, pc, oc + 3, backend="rows", accum=jd, **kw)
    tc, ti = tx.spgemm(xa, xb, pc, oc + 3, accum=xd, **kw)
    same(tc, ti, jc, ji)


def test_float64_takes_the_torch_path():
    ja, xa, jb, xb = operands()
    xa, xb = xa.with_data(xa.data.double()), xb.with_data(xb.data.double())
    pc, oc, mbr, mcr = caps(ja, jb)
    c, info = tx.spgemm(xa, xb, pc, oc, row_caps=(mbr, mcr), alpha=0.25)
    assert c.dtype == torch.float64 and not bool(info.row_overflow)
    want = 0.25 * (tx.to_dense(xa).numpy() @ tx.to_dense(xb).numpy())
    np.testing.assert_allclose(tx.to_dense(c).numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(filter_by_norm=True), dict(syrk_upper=True, filter_by_norm=True),
    dict(accum_aligned=True),
])
def test_unported_paths_raise(kw):
    """Nothing falls back quietly: each option runs on the row-panel path,
    and the row-group kernel, which takes none of them, raises."""
    _, xa = matrix_pair(2, 2, 128, 1.0, 41)
    if kw.get("accum_aligned"):
        kw = dict(kw, accum=tx.spgemm(xa, xa, 8, 4)[0])
    _, info = tx.spgemm(xa, xa, 8, 4, backend="rows", row_caps=(8, 8), **kw)
    assert not bool(info.plan_mismatch)
    with pytest.raises(ValueError, match="filter_by_norm|rows backend"):
        tx.spgemm(xa, xa, 8, 4, backend="groups", group_caps=(2, 8, 8, 8), **kw)
