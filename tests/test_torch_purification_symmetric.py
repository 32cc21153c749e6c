"""Symmetric SP2 purification (models/purification.py with
``symmetric=True``: `sp2_step` planned and unplanned, `plan_purify`,
`purify_scan`, `purify`, `PurifyEngine`) in both packages, on the same
numpy-built symmetric input.  Counters, flags, ids and mirror maps are
held exactly equal; iterates within 1e-5 (the trace within 1e-5
relative).  The JAX package runs its torch-free reference path ("xla")
at leaf 16 and its row-panel kernel in interpret mode at leaf 128; the
port takes its own "auto" dispatch (at leaf 128: the row-panel kernel's
plain version with the `triu` skip).  Mirrors tests/test_models.py:52,
:523 and :577."""

import dataclasses

import numpy as np
import pytest
import torch

import bench
import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.models import purification as jpur
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import banded_block_matrix

from torch_port_helpers import assert_same_matrix, to_port

TOL = dict(rtol=1e-5, atol=1e-5)
N, B, NOCC = 128, 16, 40


def hamiltonian(n, seed):
    """tests/test_models.py's symmetric banded Hamiltonian and its SP2
    start X0 = (hi I - H) / (hi - lo)."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for k in range(-4, 5):
        d += np.diag(rng.standard_normal(n - abs(k)).astype(np.float32) * 0.3, k)
    d = (d + d.T) / 2
    lo, hi = np.linalg.eigvalsh(d)[[0, -1]]
    return d, (hi * np.eye(n, dtype=np.float32) - d) / (hi - lo)


def same_stats(got, want):
    """Every stats field exactly; the trace within 1e-5 relative."""
    for f in dataclasses.fields(want):
        g = np.asarray(getattr(got, f.name).numpy())
        w = np.asarray(getattr(want, f.name))
        if f.name == "trace":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_sp2_symmetric_matches_generic():
    """test_models.py:52 in both packages (unplanned `purify`): the
    symmetric iterate is exactly symmetric, within 1e-5 of the JAX
    symmetric iterate and near the generic one, with ~half the pairs."""
    _, x0 = hamiltonian(N, 0)
    jX = jx.from_dense(x0, block_size=B)
    tX = to_port(jX)
    nb = N // B
    kw = dict(tau=1e-8, pair_cap=nb**3, out_cap=nb * nb, target_trace=NOCC)
    steps = 12
    tg, sg = tx.purify(tX, steps, **kw)
    ts, ss = tx.purify(tX, steps, symmetric=True, **kw)
    js, jss = jpur.purify(jX, steps, symmetric=True, backend="xla", **kw)
    for a, b in zip(ss, jss):
        same_stats(a, b)
        assert not bool(a.pair_overflow | a.out_overflow | a.repack_overflow)
    assert_same_matrix(ts, js, **TOL)
    ds, dg = tx.to_dense(ts).numpy(), tx.to_dense(tg).numpy()
    np.testing.assert_array_equal(ds, ds.T)
    assert np.linalg.norm(ds - dg) < 5e-3 * max(1.0, np.linalg.norm(dg))
    pg = sum(int(s.n_block_pairs) for s in sg)
    ps = sum(int(s.n_block_pairs) for s in ss)
    assert ps < 0.65 * pg, (ps, pg)


def test_planned_symmetric_purification():
    """test_models.py:523 in both packages: plan_purify(symmetric=True)
    plans equal to the JAX package's (mirror maps included), the planned
    symmetric scan's stats equal to JAX's, fewer pairs than the generic
    scan per step and at least half, an exactly symmetric iterate within
    1e-4 / 1e-5 of the generic planned scan, and a stale plan loud."""
    _, x0 = hamiltonian(N, 2)
    jX = jx.from_dense(x0, block_size=B)
    tX = to_port(jX)
    steps, tau = 5, 1e-8
    prof = tx.profile_purify(tX, steps, tau, target_trace=NOCC)
    jprof = jpur.profile_purify(jX, steps, tau, target_trace=NOCC, backend="xla")
    assert dataclasses.asdict(prof) == dataclasses.asdict(jprof)
    kw = dict(target_trace=NOCC, **prof.kwargs())
    plans_g = tx.plan_purify(tX, steps, tau, prof, target_trace=NOCC)
    plans_s = tx.plan_purify(tX, steps, tau, prof, target_trace=NOCC, symmetric=True)
    jplans_s = jpur.plan_purify(jX, steps, tau, jprof, target_trace=NOCC, backend="xla",
                                symmetric=True)
    for f in ("out_ids", "mirror_src", "total_syrk", "mirror_ok", "total", "seg"):
        np.testing.assert_array_equal(getattr(plans_s.plans, f).numpy(),
                                      np.asarray(getattr(jplans_s.plans, f)), err_msg=f)
    yg, sg = tx.purify_scan(tX, steps, tau, plans=plans_g, **kw)
    ys, ss = tx.purify_scan(tX, steps, tau, plans=plans_s, symmetric=True, **kw)
    jys, jss = jpur.purify_scan(jX, steps, tau, plans=jplans_s, symmetric=True,
                                backend="xla", **kw)
    same_stats(ss, jss)
    assert_same_matrix(ys, jys, **TOL)
    assert not bool((ss.plan_mismatch | ss.pair_overflow | ss.out_overflow).any())
    pg, ps = sg.n_block_pairs.numpy(), ss.n_block_pairs.numpy()
    assert (ps < pg).all() and (ps >= pg // 2).all(), (ps, pg)
    np.testing.assert_array_equal(ps, plans_s.plans.total_syrk.numpy())
    dg, ds = tx.to_dense(yg).numpy(), tx.to_dense(ys).numpy()
    np.testing.assert_array_equal(ds, ds.T)
    np.testing.assert_allclose(ds, dg, rtol=1e-4, atol=1e-5)

    x1 = x0.copy()
    x1[:B, -B:] = 0.05
    x1[-B:, :B] = 0.05
    tX1 = tx.from_dense(torch.from_numpy((x1 + x1.T) / 2), block_size=B)
    assert int(tX1.nnz) <= prof.cap
    _, s_bad = tx.purify_scan(tX1, steps, tau, plans=plans_s, symmetric=True, **kw)
    assert bool(s_bad.plan_mismatch.any())
    with pytest.raises(ValueError, match="sym_mirror"):
        tx.sp2_step(tX, tau, symmetric=True, plan=plans_g.step(0), **prof.kwargs())


def test_purify_engine_symmetric():
    """test_models.py:577: PurifyEngine(symmetric=True) plans once,
    reuses the plan, converges to the spectral projector and keeps the
    iterate exactly symmetric."""
    d, x0 = hamiltonian(N, 4)
    tX = tx.from_dense(torch.from_numpy(x0), block_size=B)
    eng = tx.PurifyEngine(30, 1e-8, target_trace=NOCC, symmetric=True)
    eng.run(tX)
    assert eng.n_replans == 1
    d2, s2 = eng.run(tX)
    assert eng.n_replans == 1
    assert not bool(s2.plan_mismatch.any())
    got = tx.to_dense(d2).numpy().astype(np.float64)
    _, vv = np.linalg.eigh(d.astype(np.float64))
    proj = vv[:, :NOCC] @ vv[:, :NOCC].T
    assert np.linalg.norm(got - proj) / np.linalg.norm(proj) < 5e-3
    np.testing.assert_array_equal(got, got.T)


def test_symmetric_scan_at_leaf_128_matches_jax():
    """B3's shape of input at 512^2 (band 40 at leaf 128, symmetrised,
    scaled and shifted), 3 steps: the port's symmetric scans, unplanned and planned
    (the row-panel kernel's triu skip), against the JAX package's on its
    row-panel kernel in interpret mode: stats exactly, iterates within
    1e-5; and the port's iterate exactly symmetric."""
    n, steps, tau, target = 512, 3, 2e-3, 256.0
    ja = bench.banded_block_matrix(n, 40, 128)
    ta = banded_block_matrix(n, 40, 128, device="cpu")
    ja = jx.add(ja, jx.transpose(ja), alpha=0.5, beta=0.5)
    ta = tx.add(ta, tx.transpose(ta), alpha=0.5, beta=0.5)
    ja = jx.add(jx.scale(ja, 0.05), jx.eye(n, 128), beta=0.5, cap=ja.cap + n // 128)
    ta = tx.add(tx.scale(ta, 0.05), tx.eye(n, 128, device="cpu"), beta=0.5, cap=ta.cap + n // 128)
    assert_same_matrix(ta, ja)
    prof = tx.profile_purify(ta, steps, tau, target_trace=target)
    kw = dict(target_trace=target, **prof.kwargs())
    plans = tx.plan_purify(ta, steps, tau, prof, target_trace=target, symmetric=True)
    jprof = jpur.CapacityProfile(**dataclasses.asdict(prof))
    jplans = jpur.plan_purify(ja, steps, tau, jprof, target_trace=target, backend="rows",
                              symmetric=True)
    for f in ("mirror_src", "total_syrk", "mirror_ok"):
        np.testing.assert_array_equal(getattr(plans.plans, f).numpy(),
                                      np.asarray(getattr(jplans.plans, f)), err_msg=f)
    tu, su = tx.purify_scan(ta, steps, tau, symmetric=True, **kw)
    tp, sp = tx.purify_scan(ta, steps, tau, plans=plans, symmetric=True, **kw)
    ju, jsu = jpur.purify_scan(ja, steps, tau, symmetric=True, backend="rows", **kw)
    jp, jsp = jpur.purify_scan(ja, steps, tau, plans=jplans, symmetric=True, backend="rows",
                               **kw)
    same_stats(su, jsu)
    same_stats(sp, jsp)
    assert_same_matrix(tu, ju, **TOL)
    assert_same_matrix(tp, jp, **TOL)
    for y in (tu, tp):
        dense = tx.to_dense(y)
        assert torch.equal(dense, dense.T)
