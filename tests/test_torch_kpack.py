"""PyTorch port vs the JAX package: packed-contraction SpGEMM
(ops/kpack.py), as in tests/test_kpack.py.  The same numpy-built inputs
go through both packages on the CPU: every plan table and count exactly
equal, C's ids and counters exactly, payloads within 1e-5 of max|C| at
"highest" and 2e-3 at "default"."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops import kpack as jkp
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu_torch.ops import kpack as tkp
from hierarchical_block_sparse_lib_tpu_torch.ops.repack import coarsen, plan_coarsen
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.runtime import native as tnative

from torch_port_helpers import (
    assert_same_info,
    assert_same_plan,
    bf16_rounded,
    matrix_pair,
    np_,
    rel_to_max,
    to_port,
)

TOL = {"highest": 1e-5, "default": 2e-3}


def random_fine(n, bf, density, seed=0):
    """(JAX, port) uniform-random block-sparse matrix at leaf bf (the B2
    shape, scaled down), and its dense form."""
    jm, tm = matrix_pair(n // bf, n // bf, bf, density, seed)
    return jm, tm, tx.to_dense(tm).numpy()


def _check(ja, jb, ta, tb, d, tile, alpha=1.0, n_groups=4, precision="highest",
           layout="plain"):
    """Plans equal, the product in both packages against each other, the
    dense oracle `d` and the fine pair count."""
    jplan = jkp.plan_kpack(ja, jb, tile=tile, n_groups=n_groups)
    tplan = tkp.plan_kpack(ta, tb, tile=tile, n_groups=n_groups)
    assert tplan is not None
    assert_same_plan(tplan, jplan)
    assert tplan.inflation == jplan.inflation
    jc, ji = jkp.kpack_spgemm(ja, jb, jplan, alpha=alpha, precision=precision, layout=layout)
    tc, ti = tkp.kpack_spgemm(ta, tb, tplan, alpha=alpha, precision=precision, layout=layout)
    assert tc.block_size == jc.block_size == tile
    np.testing.assert_array_equal(np_(tc.ids), np.asarray(jc.ids))
    assert int(tc.nnz) == int(jc.nnz)
    assert rel_to_max(np_(tc.data), np.asarray(jc.data)) <= TOL[precision]
    assert_same_info(ti, ji)
    assert not bool(ti.plan_mismatch)
    np.testing.assert_allclose(tx.to_dense(tc).numpy(), alpha * d, rtol=2e-4, atol=1e-3)
    n_pairs, _ = plan_spgemm(ja, jb)
    assert tplan.n_leaf_pairs == n_pairs == int(ti.n_block_pairs)
    ids = np_(tc.ids)
    assert (np.diff(ids) > 0).all()
    return tplan, tc


def test_random_kpack_vs_jax_and_oracle():
    """Scaled-down B2: uniform random 8% at leaf 16, tiles of 4x4 leaves."""
    ja, ta, dA = random_fine(512, 16, 0.08, seed=2)
    plan, tc = _check(ja, ja, ta, ta, dA @ dA, tile=64)
    f = 64 // 16
    ac = coarsen(ta, f, cap=plan_coarsen(ta, f))
    pc, _, _, _ = plan_spgemm_ex(ac, ac)
    assert plan.panel_flops < 0.55 * 2 * 64**3 * pc
    # The tiles are the FINE product's support rounded to tiles.
    cf, _ = tx.matmul(ta, ta, backend="xla")
    fids = np_(cf.ids)[: int(cf.nnz)].astype(np.int64)
    nbj = -(-ta.nb_cols // f)
    ref = np.unique((fids // ta.nb_cols // f) * nbj + (fids % ta.nb_cols) // f)
    np.testing.assert_array_equal(np_(tc.ids)[: int(tc.nnz)], ref.astype(np.int32))


def test_kpack_default_tier():
    """"default": the port stores the packed operands in bf16 and sums
    exact products in f32, as the reference's single bf16 pass does; JAX's
    CPU dots do not round, so JAX is handed the rounded operands."""
    ja, ta, _ = random_fine(256, 16, 0.1, seed=5)
    jr = ja.with_data(bf16_rounded(np.array(ja.data)))
    d = tx.to_dense(to_port(jr)).numpy()
    _check(jr, jr, ta, ta, d @ d, tile=64, precision="default")


def test_kpack_alpha_and_groups():
    ja, ta, dA = random_fine(256, 16, 0.1, seed=5)
    _check(ja, ja, ta, ta, dA @ dA, tile=64, alpha=-0.5, n_groups=1)
    _check(ja, ja, ta, ta, dA @ dA, tile=64, alpha=2.0, n_groups=7)


def test_kpack_rectangular():
    bf, tile = 16, 32
    rng = np.random.default_rng(3)
    dA = np.zeros((128, 192), np.float32)
    dB = np.zeros((192, 96), np.float32)
    for d in (dA, dB):
        for i in range(0, d.shape[0], bf):
            for j in range(0, d.shape[1], bf):
                if rng.random() < 0.3:
                    d[i:i + bf, j:j + bf] = rng.standard_normal((bf, bf))
    ra, ca = np.nonzero(dA)
    rb, cb = np.nonzero(dB)
    ja = jx.from_coo(ra, ca, dA[ra, ca], 128, n_cols=192, block_size=bf)
    jb = jx.from_coo(rb, cb, dB[rb, cb], 192, n_cols=96, block_size=bf)
    _check(ja, jb, to_port(ja), to_port(jb), dA @ dB, tile=tile, n_groups=3)


def test_kpack_counter_matches_occupancy_path(monkeypatch):
    """kpack's honest counter == the coarsen(track_leaves) occupancy
    counter == the host fine plan, with and without the native library."""
    ja, ta, _ = random_fine(512, 16, 0.06, seed=9)
    f = 4
    ac, occ = coarsen(ta, f, cap=plan_coarsen(ta, f), track_leaves=True)
    pc, oc, _, _ = plan_spgemm_ex(ac, ac)
    _, info = tx.spgemm(ac, ac, pc, oc, a_leaf_occ=occ, b_leaf_occ=occ, backend="xla")
    n_fine, _ = plan_spgemm(ja, ja)
    assert int(info.n_leaf_multiplies) == n_fine
    assert tkp.plan_kpack(ta, ta, tile=f * 16).n_leaf_pairs == n_fine
    monkeypatch.setattr(tnative, "have_native", lambda: False)
    assert tkp.plan_kpack(ta, ta, tile=f * 16).n_leaf_pairs == n_fine


def test_kpack_guard_and_mismatch():
    ja, ta, _ = random_fine(256, 16, 0.1, seed=11)
    # tile == leaf (no aggregation): no plan in either package.
    assert tkp.plan_kpack(ta, ta, tile=16) is None and jkp.plan_kpack(ja, ja, tile=16) is None
    plan = tkp.plan_kpack(ta, ta, tile=64)
    # A stale plan (another structure at the same capacity) is loud.
    _, t2, _ = random_fine(256, 16, 0.1, seed=12)
    assert t2.ids.shape == ta.ids.shape
    _, info = tkp.kpack_spgemm(t2, t2, plan)
    assert bool(info.plan_mismatch)


def test_kpack_layouts_one_formulation():
    """The reference's three layouts are one formulation in the port: the
    same bits for each; an unknown layout raises, as in the reference."""
    ja, ta, dA = random_fine(256, 16, 0.1, seed=7)
    _, ref = _check(ja, ja, ta, ta, dA @ dA, tile=64, n_groups=3)
    plan = tkp.plan_kpack(ta, ta, tile=64, n_groups=3)
    for layout in ("t", "mc"):
        _check(ja, ja, ta, ta, dA @ dA, tile=64, n_groups=3, layout=layout)
        c, _ = tkp.kpack_spgemm(ta, ta, plan, layout=layout)
        assert torch.equal(c.data, ref.data)
    with pytest.raises(ValueError, match="layout"):
        tkp.kpack_spgemm(ta, ta, plan, layout="plian")


def test_kpack_empty_tiles_absent():
    """A product whose support misses some coarse tiles: exactly the
    touched tiles, no more."""
    bf, tile, n = 16, 64, 256
    dA = np.zeros((n, n), np.float32)
    dA[0:bf, 0:bf] = 1.0
    dA[192:192 + bf, 192:192 + bf] = 2.0
    ra, ca = np.nonzero(dA)
    ja = jx.from_coo(ra, ca, dA[ra, ca], n, block_size=bf)
    plan, _ = _check(ja, ja, to_port(ja), to_port(ja), dA @ dA, tile=tile)
    assert plan.n_tiles == 2
