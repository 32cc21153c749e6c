"""The symmetric product (ops/spgemm.py's upper-triangle enumeration,
`SyrkPlan`/`plan_syrk`, `make_plan(sym_mirror=True)`; ops/matmul.py
`syrk`; ops/basic.py `filter_blocks`/`triu`/`tril`/`symmetrize_upper`) in
both packages: the same numpy-built inputs through the JAX functions and
the port's (its kernels' plain versions on the CPU).  Ids, counters,
plans and mirror maps are held exactly equal, payloads within 1e-5
relative at "highest".  Mirrors tests/test_basic_ops.py:198-327."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops import basic as jbasic
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm, plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as tfine
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as trows
from hierarchical_block_sparse_lib_tpu_torch.ops import basic as tbasic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_syrk as t_plan_syrk

from torch_port_helpers import (
    assert_same_info,
    assert_same_matrix,
    matrix_pair,
    np_,
    to_port,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def dense_pair(n, b, density, seed, sym=False):
    """(dense, JAX matrix, port matrix) of a random pattern at leaf b."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < density)).astype(np.float32)
    if sym:
        d = (d + d.T) / 2
    jm = jx.from_dense(d, block_size=b)
    return d, jm, to_port(jm)


def block_pattern(nb, b, keep_p, seed):
    """A dense n x n matrix whose b x b blocks are kept with probability
    keep_p (so every kept block is full)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((nb, nb)) < keep_p
    d = rng.standard_normal((nb * b, nb * b)).astype(np.float32)
    return d * np.kron(keep, np.ones((b, b), np.float32))


def test_symbolic_syrk_upper_matches_jax():
    """spgemm_symbolic(syrk_upper=True) on (A, A^T): the same pair lists,
    total (upper pairs) and raw_total (all pairs) as the JAX package."""
    _, ja, ta = dense_pair(96, 16, 0.3, 13)
    jt, tt = jx.transpose(ja), tx.transpose(ta)
    n_pairs, _ = plan_spgemm(ja, jt)
    pair_cap = n_pairs + 5
    got = tx.spgemm_symbolic(ta, tt, pair_cap, syrk_upper=True)
    want = jx.spgemm_symbolic(ja, jt, pair_cap, syrk_upper=True)
    for g, w in zip(got, want):
        assert np_(g).dtype == np.int32
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    assert int(got[4]) == n_pairs > int(got[3]) > n_pairs // 2 - 1


def test_plan_syrk_matches_jax():
    _, ja, ta = dense_pair(96, 16, 0.3, 13)
    from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_syrk as j_plan_syrk

    got, want = t_plan_syrk(ta), j_plan_syrk(ja)
    for f in want.__slots__:
        assert getattr(got, f) == getattr(want, f), f
    assert got.out_full == want.out_full
    full_pairs, _ = plan_spgemm(ja, jx.transpose(ja))
    assert got.pairs_raw == full_pairs and got.pairs_upper < full_pairs


def test_make_plan_sym_mirror_matches_jax():
    """make_plan(sym_mirror=True) on a symmetric structure: every field,
    the mirror map, total_syrk and mirror_ok included, as the JAX
    package's; an asymmetric union reports mirror_ok False."""
    d = block_pattern(8, 16, 0.2, 29)
    ja = jx.from_dense(d + d.T, block_size=16)
    ta = to_port(ja)
    pc, oc = plan_spgemm(ja, ja)
    out_cap = oc + int(ja.nnz)
    got = tx.make_plan(ta, ta, pc, accum_ids=ta.ids, out_cap=out_cap, sym_mirror=True)
    want = jx.make_plan(ja, ja, pc, accum_ids=ja.ids, out_cap=out_cap, sym_mirror=True)
    for f in ("a_idx", "b_idx", "c_id", "total", "raw_total", "a_ids", "b_ids", "out_ids",
              "seg", "pos_acc", "n_unique", "acc_ids", "mirror_src", "total_syrk",
              "mirror_ok"):
        g, w = np_(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype.kind == w.dtype.kind, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert bool(got.mirror_ok) and int(got.total_syrk) < int(got.total)
    assert int(got.n_unique) < 64  # a block-sparse union
    jb = jx.from_dense(block_pattern(8, 16, 0.2, 30), block_size=16)  # not symmetric
    tb = to_port(jb)
    pcb, ocb = plan_spgemm(jb, jb)
    bad = tx.make_plan(tb, tb, pcb, accum_ids=tb.ids, out_cap=ocb + int(jb.nnz), sym_mirror=True)
    jbad = jx.make_plan(jb, jb, pcb, accum_ids=jb.ids, out_cap=ocb + int(jb.nnz), sym_mirror=True)
    assert bool(bad.mirror_ok) == bool(jbad.mirror_ok) is False
    with pytest.raises(ValueError, match="sym_mirror"):
        tx.make_plan(ta, ta, pc, sym_mirror=True)


@pytest.mark.parametrize("kw", [dict(alpha=0.5), dict(transpose=True), dict(full=False)])
def test_syrk_matches_jax(kw):
    """syrk at leaf 16 (the port's torch path, JAX's stream kernel in
    interpret mode): ids and counters exact, payload within 1e-5, and
    against the dense product."""
    d, ja, ta = dense_pair(96, 16, 0.3, 13)
    tc, ti = tx.syrk(ta, **kw)
    jc, ji = jx.syrk(ja, **kw)
    assert_same_matrix(tc, jc, **TOL)
    assert_same_info(ti, ji)
    assert int(ti.n_block_pairs) == t_plan_syrk(
        tx.transpose(ta) if kw.get("transpose") else ta).pairs_upper
    want = d.T @ d if kw.get("transpose") else kw.get("alpha", 1.0) * (d @ d.T)
    if kw.get("full", True):
        np.testing.assert_allclose(tx.to_dense(tc).numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        nb = 6
        upper = np.kron(np.triu(np.ones((nb, nb))), np.ones((16, 16)))
        np.testing.assert_allclose(tx.to_dense(tc).numpy(), want * upper, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend", ["rows", "pallas"])
def test_syrk_128_matches_jax(backend):
    """test_basic_ops.py::test_syrk_rows_backend in both packages: syrk at
    b = 128 on the row-panel kernel (its triu skip) and on the pair-stream
    kernel (the symbolic filter), the port's plain versions against the
    JAX kernels in interpret mode."""
    d = block_pattern(4, 128, 0.6, 17)
    ja = jx.from_dense(d, block_size=128)
    ta = to_port(ja)
    jc, ji = jx.syrk(ja, backend=backend)
    tc, ti = tx.syrk(ta, backend=backend)
    assert_same_info(ti, ji)
    assert not bool(ti.pair_overflow) and not bool(ti.out_overflow)
    np.testing.assert_array_equal(tc.ids.numpy(), np.asarray(jc.ids))
    scale = np.abs(np.asarray(jc.data)).max()
    assert np.abs(tc.data.numpy() - np.asarray(jc.data)).max() <= 1e-5 * scale
    exact = d.astype(np.float64) @ d.T.astype(np.float64)
    assert np.abs(tx.to_dense(tc).numpy() - exact).max() <= 1e-5 * np.abs(exact).max()


def test_auto_syrk_takes_rows_and_declines_groups_and_fine():
    """At b = 128 with row caps "auto" runs syrk on the row-panel kernel;
    "groups" and "fine" raise on syrk_upper, as in the JAX package, and
    resolve_backend never picks them for it."""
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import resolve_backend

    assert resolve_backend(128, torch.float32, 4, 100, row_caps=(4, 4), group_caps=(16, 4, 4, 4),
                           syrk_upper=True) == "rows"
    assert resolve_backend(32, torch.float32, 4, 100, row_caps=(4, 4),
                           syrk_upper=True) == "xla"
    _, ja, ta = dense_pair(64, 32, 0.5, 3)
    tt = tx.transpose(ta)
    for backend, caps in (("fine", dict(row_caps=(8, 8))),
                          ("groups", dict(group_caps=(16, 8, 8, 8)))):
        with pytest.raises(ValueError, match="syrk_upper"):
            tx.spgemm(ta, tt, 64, 64, backend=backend, syrk_upper=True, **caps)


def test_rows_triu_skip_counts_the_symbolic_pairs():
    """The row-panel kernel's triu predicate (col >= row of the A block),
    applied on the host to the pairs of its row tables, keeps exactly the
    pairs of the symbolic phase's upper filter (row <= col); and a triu
    launch (its plain version here) on the mirrored output leaves every
    strictly lower slot zero and the upper slots as a launch without it."""
    d = block_pattern(6, 128, 0.5, 5)
    ta = tx.from_dense(torch.from_numpy(d), block_size=128)
    tt = tx.transpose(ta)
    plan = t_plan_syrk(ta)
    sym = tx.spgemm_symbolic(ta, tt, plan.pairs_raw, syrk_upper=True)
    out_ids = tx.syrk(ta, full=False)[0].ids
    _, a_col, b_row_start, b_col, _, _ = tfine.build_tables(
        ta.ids, tt.ids, out_ids, ta.nb_rows, tt.nb_rows, tt.nb_cols)
    a_idx, b_idx = tfine.expand_pairs(ta.ids, a_col, b_row_start, plan.max_b_row)
    a_row = ta.ids[a_idx].long() // ta.nb_cols
    kernel_pairs = int((b_col[b_idx].long() >= a_row).sum())
    assert a_idx.numel() == plan.pairs_raw == int(sym[4])
    assert kernel_pairs == int(sym[3]) == plan.pairs_upper

    c = tx.syrk(ta)[0]
    args = (ta.ids, ta.data, tt.ids, tt.data, c.ids, ta.nb_rows, tt.nb_rows, tt.nb_cols,
            c.cap, plan.max_b_row, plan.max_c_row)
    up = trows.rows_spgemm(*args, triu=True)
    every = trows.rows_spgemm(*args, triu=False)
    valid = c.ids != tx.SENTINEL
    lower = valid & (c.ids // c.nb_cols > c.ids % c.nb_cols)
    assert int(lower.sum()) == plan.out_full - plan.out_upper > 0
    assert bool((up[lower] == 0).all())
    assert bool((every[lower] != 0).flatten(1).any(1).all())
    assert torch.equal(up[valid & ~lower], every[valid & ~lower])


def test_triu_tril_filter_blocks_match_jax():
    d, ja, ta = dense_pair(64, 16, 1.0, 23)
    ja = jx.repack(ja, ja.cap + 2)
    ta = to_port(ja)
    for name, kw in (("triu", {}), ("triu", dict(strict=True)), ("tril", {}),
                     ("tril", dict(strict=True))):
        got = getattr(tx, name)(ta, **kw)
        want = getattr(jx, name)(ja, **kw)
        assert_same_matrix(got, want, rtol=0, atol=0)
        assert got.cap == ta.cap
    up = np.kron(np.triu(np.ones((4, 4))), np.ones((16, 16)))
    np.testing.assert_array_equal(tx.to_dense(tx.triu(ta)).numpy(), d * up)
    keep = torch.from_numpy(np.arange(ta.cap) % 3 == 0)
    assert_same_matrix(tx.filter_blocks(ta, keep),
                       jx.filter_blocks(ja, np.asarray(keep.numpy())), rtol=0, atol=0)


def test_symmetrize_upper_matches_jax():
    """test_basic_ops.py::test_symmetrize_upper in both packages: the upper
    triangle mirrored down, diagonal blocks averaged with their transpose
    (exactly symmetric), overflow reported at a small cap."""
    rng = np.random.default_rng(29)
    d = rng.standard_normal((64, 64)).astype(np.float32)
    d[np.abs(d) < 0.8] = 0.0
    ja = jx.from_dense(d, block_size=16)
    ta = to_port(ja)
    got, ovf = tbasic.symmetrize_upper(ta, ta.cap + 16)
    want, jovf = jbasic.symmetrize_upper(ja, ja.cap + 16)
    assert_same_matrix(got, want, rtol=0, atol=0)
    assert bool(ovf) == bool(jovf) is False
    dense = tx.to_dense(got).numpy()
    np.testing.assert_array_equal(dense, dense.T)
    strict = np.kron(np.triu(np.ones((4, 4)), 1), np.ones((16, 16)))
    np.testing.assert_array_equal(dense * strict, d * strict)
    _, ovf2 = tbasic.symmetrize_upper(ta, 1)
    assert bool(ovf2) and bool(jbasic.symmetrize_upper(ja, 1)[1])


def test_planned_spgemm_syrk_upper_leaves_lower_slots_unmultiplied():
    """With a generic plan and syrk_upper on "rows", lower union slots get
    no product: only the accumulator's beta * X, as the JAX package."""
    d = block_pattern(4, 128, 0.7, 31)
    d = (d + d.T) / 2
    ja = jx.from_dense(d, block_size=128)
    ta = to_port(ja)
    pc, oc = plan_spgemm(ja, ja)
    out_cap = oc + int(ja.nnz)
    caps = plan_spgemm_ex(ja, ja)[2:]
    jp = jx.make_plan(ja, ja, pc, accum_ids=ja.ids, out_cap=out_cap, sym_mirror=True)
    tp = tx.make_plan(ta, ta, pc, accum_ids=ta.ids, out_cap=out_cap, sym_mirror=True)
    kw = dict(pair_cap=pc, out_cap=out_cap, row_caps=caps, beta=0.5, syrk_upper=True,
              backend="rows")
    tc, ti = tx.spgemm(ta, ta, accum=ta, plan=tp, **kw)
    jc, ji = jx.spgemm(ja, ja, accum=ja, plan=jp, **kw)
    assert_same_info(ti, ji)
    np.testing.assert_array_equal(tc.ids.numpy(), np.asarray(jc.ids))
    scale = np.abs(np.asarray(jc.data)).max()
    assert np.abs(tc.data.numpy() - np.asarray(jc.data)).max() <= 1e-5 * scale
    nb = ta.nb_cols
    ids = tc.ids.numpy()
    lower = (ids != np.iinfo(np.int32).max) & (ids // nb > ids % nb)
    acc = dict(zip(ta.ids.numpy().tolist(), ta.data.numpy()))
    assert lower.any()
    for k in np.flatnonzero(lower):
        want = 0.5 * acc[ids[k]] if ids[k] in acc else 0.0
        np.testing.assert_array_equal(tc.data[k].numpy(), want)
