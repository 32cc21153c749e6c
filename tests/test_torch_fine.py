"""PyTorch port vs the JAX package: the flat-resident fine chain
(ops/fine.py) — packing, plans and their flags, planned and unplanned
multiplies, and the chain ops, at b=32 on 8x8-block matrices."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex

from torch_port_helpers import (
    assert_same_info,
    assert_same_matrix,
    matrix_pair,
    np_,
)

B = 32


@pytest.fixture(scope="module")
def chain():
    """A (with padding slots) and its plan, in both packages."""
    ja, ta = matrix_pair(8, 8, B, 0.3, 31, empty_rows=(3,), pad=2)
    caps = plan_spgemm_ex(ja, ja)
    pc, oc, mbr, mcr = caps
    jplan = jx.make_fine_plan(ja, ja, pc, oc, (mbr, mcr))
    tplan = tx.make_fine_plan(ta, ta, pc, oc, (mbr, mcr))
    return ja, ta, caps, jplan, tplan


def assert_same_plan(tplan, jplan):
    for field in ("out_ids", "n_unique", "total", "raw_total", "a_ids",
                  "b_ids", "row_overflow"):
        got, want = np_(getattr(tplan, field)), np_(getattr(jplan, field))
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    for got, want in zip(tplan.tables, jplan.tables):
        np.testing.assert_array_equal(np_(got), np_(want))


def test_pack_unpack_match_jax(chain):
    ja, ta = chain[:2]
    jf, tf = jx.fine_pack(ja), tx.fine_pack(ta)
    assert_same_matrix(tf, jf, rtol=0, atol=0)
    assert tf.data.shape == (ta.cap, B * B // 128, 128)
    assert_same_matrix(tx.fine_unpack(tf), ja, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tx.fine_pack(matrix_pair(2, 2, 8, 1.0, 0)[1])


def test_make_fine_plan_matches_jax(chain):
    _, ta, _, jplan, tplan = chain
    assert_same_plan(tplan, jplan)
    # Planning from the packed operand gives the same plan.
    tf = tx.fine_pack(ta)
    assert_same_plan(tx.make_fine_plan(tf, tf, *chain[2][:2], chain[2][2:]), jplan)


def test_fine_matmul_planned_and_unplanned_match_jax(chain):
    ja, ta, (pc, oc, mbr, mcr), jplan, tplan = chain
    jf, tf = jx.fine_pack(ja), tx.fine_pack(ta)
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=(mbr, mcr), alpha=0.75)
    jc, jinfo = jx.fine_matmul(jf, jf, plan=jplan, **kw)
    tc0, tinfo0 = tx.fine_matmul(tf, tf, **kw)
    tc1, tinfo1 = tx.fine_matmul(tf, tf, plan=tplan, **kw)
    assert torch.equal(tc0.ids, tc1.ids) and torch.equal(tc0.data, tc1.data)
    assert_same_matrix(tc1, jc)
    assert_same_info(tinfo0, jinfo)
    assert_same_info(tinfo1, jinfo)
    # Tail slots and padding are exactly zero.
    assert not torch.any(tc1.data[int(tc1.nnz):])


def test_stale_plan_sets_plan_mismatch(chain):
    ja, ta, (pc, oc, mbr, mcr), jplan, tplan = chain
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=(mbr, mcr))
    # Same capacity, other structure; and another capacity (shape).
    # Seed 32 stores round(0.3 * 64) = 19 blocks; pad them to A's capacity.
    jsame, tsame = matrix_pair(8, 8, B, 0.3, 32, pad=ta.cap - 19)
    assert tsame.cap == ta.cap
    _, tshape = matrix_pair(8, 8, B, 0.3, 32)
    for stale in (tsame, tshape):
        sf = tx.fine_pack(stale)
        _, info = tx.fine_matmul(sf, sf, plan=tplan, **kw)
        assert bool(info.plan_mismatch)
    jf = jx.fine_pack(jsame)
    _, jinfo = jx.fine_matmul(jf, jf, plan=jplan, **kw)
    assert bool(jinfo.plan_mismatch)
    with pytest.raises(ValueError):
        tx.fine_matmul(tx.fine_pack(ta), tx.fine_pack(ta), pc, oc + 1,
                       (mbr, mcr), plan=tplan)


@pytest.mark.parametrize("which", [0, 1])  # the B-row cap, the C-row cap
def test_undersized_row_caps_set_row_overflow(which):
    ja, ta = matrix_pair(24, 24, 16, 0.5, 35)
    pc, oc, mbr, mcr = plan_spgemm_ex(ja, ja)
    caps = [mbr, mcr]
    assert caps[which] > 8  # above the smallest bucket
    caps[which] = 1  # bucketed to 8
    tplan = tx.make_fine_plan(ta, ta, pc, oc, tuple(caps))
    jplan = jx.make_fine_plan(ja, ja, pc, oc, tuple(caps))
    assert_same_plan(tplan, jplan)
    assert bool(tplan.row_overflow)
    tf = tx.fine_pack(ta)
    _, info = tx.fine_matmul(tf, tf, pc, oc, tuple(caps))
    assert bool(info.row_overflow)


def test_fine_chain_ops_match_jax(chain):
    ja, ta = chain[:2]
    jd, td = matrix_pair(8, 8, B, 0.25, 33, pad=1)
    jf, tf = jx.fine_pack(ja), tx.fine_pack(ta)
    jg, tg = jx.fine_pack(jd), tx.fine_pack(td)
    jsum = jx.fine_add(jf, jg, alpha=2.0, beta=-0.5)
    tsum = tx.fine_add(tf, tg, alpha=2.0, beta=-0.5)
    assert_same_matrix(tsum, jsum)
    assert_same_matrix(tx.fine_add(tf, tg, cap=10), jx.fine_add(jf, jg, cap=10))
    assert_same_matrix(tx.fine_scale(tsum, torch.tensor(-3.0)), jx.fine_scale(jsum, -3.0))
    np.testing.assert_allclose(
        float(tx.fine_frob_squared(tsum)), float(jx.fine_frob_squared(jsum)), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(tx.fine_trace(tsum)), float(jx.fine_trace(jsum)), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        float(tx.fine_trace(tsum)), float(np.trace(np.asarray(jx.to_dense(jx.fine_unpack(jsum))))),
        rtol=1e-5, atol=1e-5,
    )
    # Blocks of 2A have norms near 64, blocks only in -0.5D near 16, so
    # tau = 40 splits them far from any tie.
    for cap in (None, 6):
        got = tx.fine_truncate(tsum, 40.0, cap=cap)
        want = jx.fine_truncate(jsum, 40.0, cap=cap)
        assert_same_matrix(got, want)
        assert 0 < int(got.nnz) < int(tsum.nnz)


def test_fine_sp2_step_matches_jax():
    rng = np.random.default_rng(34)
    n = 8 * B
    h = rng.standard_normal((n, n))
    _, v = np.linalg.eigh((h + h.T) / 2)
    w = np.concatenate([np.linspace(0.95, 0.7, n // 4), np.linspace(0.3, 0.05, n - n // 4)])
    x = ((v * w) @ v.T).astype(np.float32)
    jxm = jx.from_dense(x, block_size=B)
    txm = tx.from_dense(x, block_size=B)
    pc, oc, mbr, mcr = plan_spgemm_ex(jxm, jxm)
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=(mbr, mcr), target_trace=n // 4, cap=oc)
    jy, (jt, jinfo) = jx.fine_sp2_step(jx.fine_pack(jxm), 1e-3, **kw)
    ty, (tt, tinfo) = tx.fine_sp2_step(tx.fine_pack(txm), 1e-3, **kw)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    assert_same_info(tinfo, jinfo)
    assert_same_matrix(ty, jy)
    assert ty.cap == oc
