"""The model drivers of the port (models/polynomial.py, chebyshev.py,
inverse_factor.py) against the JAX package's and against dense float64
oracles, after tests/test_models.py: each model's result against the JAX
model's (ids exactly, payloads within 1e-5 of max), planned against
unplanned bitwise, structural drift flagged.  Also the planned add both
chebyshev paths use, the export lists, the port's entry step against the
JAX entry's and the purification demo.  All at b = 16 ("auto" runs
"xla" in both packages), except the entry step (b = 128, the row-panel
and norm kernels' plain versions)."""

import dataclasses

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu.models as jmodels
import hierarchical_block_sparse_lib_tpu_torch as tx
import hierarchical_block_sparse_lib_tpu_torch.models as tmodels

from torch_port_helpers import JAX_CACHE_SETTINGS, assert_same_matrix, matrix_pair, np_


def _same(port_m, jax_m):
    scale = float(np.abs(np.asarray(jax_m.data)).max())
    assert_same_matrix(port_m, jax_m, rtol=1e-5, atol=1e-5 * scale)


def _bitwise(x, y):
    assert torch.equal(x.ids, y.ids) and torch.equal(x.data, y.data)


def _from_dense(d, b):
    return jx.from_dense(d, block_size=b), tx.from_dense(torch.from_numpy(np.ascontiguousarray(d)),
                                                         block_size=b)


def test_exports_match_jax():
    """Every name of the JAX package's __all__ (none of them in parallel/)
    and all 19 of its models/__init__ are exported by the port."""
    assert set(jx.__all__) <= set(tx.__all__)
    assert all(hasattr(tx, name) for name in tx.__all__)
    assert len(jmodels.__all__) == 19
    assert set(jmodels.__all__) == set(tmodels.__all__)
    assert all(hasattr(tmodels, name) for name in tmodels.__all__)


# Horner (tests/test_models.py:101 and :185).


def test_polynomial_matches_dense_horner_and_jax():
    n, b = 96, 16
    rng = np.random.default_rng(2)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)).astype(np.float32) * 0.1
    ja, ta = _from_dense(d, b)
    coeffs = [0.5, -1.0, 0.25, 2.0]
    nb = n // b
    P, pairs, ovf = tmodels.polynomial(ta, coeffs, tau=0.0, pair_cap=nb**3, out_cap=nb * nb)
    assert not bool(ovf) and int(pairs) > 0
    dd = d.astype(np.float64)
    want = 0.5 * np.eye(n) - dd + 0.25 * (dd @ dd) + 2.0 * (dd @ dd @ dd)
    np.testing.assert_allclose(tx.to_dense(P).numpy(), want, rtol=1e-4, atol=1e-5)
    JP, jpairs, _ = jmodels.polynomial(ja, coeffs, tau=0.0, pair_cap=nb**3, out_cap=nb * nb)
    _same(P, JP)
    assert int(pairs) == int(jpairs)


def _tridiag_blocks(n, b, seed, scale):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    nb = n // b
    for i in range(nb):
        for j in range(nb):
            if abs(i - j) <= 1:
                d[i * b:(i + 1) * b, j * b:(j + 1) * b] = rng.standard_normal((b, b)) * scale
    return d


def test_polynomial_planned_identical_and_drift_flagged():
    n, b = 128, 16
    d = _tridiag_blocks(n, b, 2, 0.1)
    ja, ta = _from_dense(d, b)
    nb = n // b
    c, pc, oc = [0.3, -0.5, 0.2, 0.7], nb**3, nb * nb
    P1, t1, o1 = tmodels.polynomial(ta, c, 1e-8, pair_cap=pc, out_cap=oc)
    plans = tmodels.plan_polynomial(ta, c, 1e-8, pair_cap=pc, out_cap=oc)
    P2, t2, o2 = tmodels.polynomial(ta, c, 1e-8, pair_cap=pc, out_cap=oc, plans=plans)
    assert not bool(o1) and not bool(o2) and int(t1) == int(t2)
    _bitwise(P1, P2)
    JP, jt, jo = jmodels.polynomial(ja, c, 1e-8, pair_cap=pc, out_cap=oc)
    _same(P2, JP)
    assert int(jt) == int(t1) and not bool(jo)
    d3 = d.copy()
    d3[:b, b:2 * b] = 0.0
    d3[:b, -b:] = 0.1
    A3 = tx.from_dense(torch.from_numpy(d3), block_size=b)
    assert A3.cap == ta.cap  # a same-capacity move of one block
    assert bool(tmodels.polynomial(A3, c, 1e-8, pair_cap=pc, out_cap=oc, plans=plans)[2])


# Newton-Schulz (tests/test_models.py:125 and :225).


def test_inverse_sqrt_newton_schulz():
    n, b = 96, 16
    rng = np.random.default_rng(4)
    m = np.zeros((n, n), np.float32)
    for k in range(1, 4):
        v = rng.standard_normal(n - k).astype(np.float32) * 0.05
        m += np.diag(v, k) + np.diag(v, -k)
    S_d = np.eye(n, dtype=np.float32) + m
    S = tx.from_dense(torch.from_numpy(S_d), block_size=b)
    nb = n // b
    theta = float(np.linalg.norm(S_d, 2)) * 1.1
    Z, total, ovf = tmodels.inv_sqrt_newton_schulz(
        S, theta, n_steps=25, tau=0.0, pair_cap=nb**3, out_cap=nb * nb)
    assert not bool(ovf) and int(total) > 0
    Zd = tx.to_dense(Z).double().numpy()
    err = np.linalg.norm(Zd.T @ S_d.astype(np.float64) @ Zd - np.eye(n))
    assert err < 1e-4, err


def test_newton_schulz_planned_identical_jax_and_drift_flagged():
    n, b = 128, 16
    d = _tridiag_blocks(n, b, 8, 0.05)
    d = (d + d.T) / 2 + np.eye(n, dtype=np.float32)
    js, ts = _from_dense(d, b)
    theta = float(np.sqrt(float(tx.frob_squared(ts))))
    nb = n // b
    pc, oc = nb**3, nb * nb
    Z1, t1, o1 = tmodels.inv_sqrt_newton_schulz(ts, theta, 8, 1e-8, pair_cap=pc, out_cap=oc)
    plans = tmodels.plan_inv_sqrt(ts, theta, 8, 1e-8, pair_cap=pc, out_cap=oc)
    Z2, t2, o2 = tmodels.inv_sqrt_newton_schulz(ts, theta, 8, 1e-8, pair_cap=pc, out_cap=oc,
                                                  plans=plans)
    assert not bool(o1) and not bool(o2) and int(t1) == int(t2)
    _bitwise(Z1, Z2)
    JZ, jt, jo = jmodels.inv_sqrt_newton_schulz(js, theta, 8, 1e-8, pair_cap=pc, out_cap=oc)
    _same(Z2, JZ)
    assert int(jt) == int(t1) and not bool(jo)
    w, v = np.linalg.eigh(d.astype(np.float64))
    want = (v / np.sqrt(w)) @ v.T
    assert np.abs(tx.to_dense(Z2).double().numpy() - want).max() < 1e-4
    d3 = d.copy()
    d3[:b, -b:] = 0.03
    d3[-b:, :b] = 0.03
    S3 = tx.from_dense(torch.from_numpy((d3 + d3.T) / 2), block_size=b)
    _, _, o3 = tmodels.inv_sqrt_newton_schulz(S3, theta, 8, 1e-8, pair_cap=pc, out_cap=oc,
                                                plans=plans)
    assert bool(o3)


# Chebyshev (tests/test_models.py:152 and :274).


def _cheb_h(n, b):
    rng = np.random.default_rng(6)
    m = np.zeros((n, n), np.float32)
    for k in range(0, 4):
        v = rng.standard_normal(n - k).astype(np.float32) * 0.1
        m += np.diag(v, k) + (np.diag(v, -k) if k else 0)
    return ((m + m.T) / 2).astype(np.float64)


def test_chebyshev_fermi_expansion_and_gershgorin_scaling():
    n, b = 96, 16
    H_d = _cheb_h(n, b)
    H0 = tx.from_dense(torch.from_numpy(H_d.astype(np.float32)), block_size=b)
    bound = float(tx.gershgorin_bound(H0)) * 1.05
    np.testing.assert_allclose(bound / 1.05, np.abs(H_d.astype(np.float32)).sum(1).max(), rtol=1e-5)
    Hs = (H_d / bound).astype(np.float32)
    H = tx.from_dense(torch.from_numpy(Hs), block_size=b)
    f = lambda x: 1.0 / (1.0 + np.exp(6.0 * x))  # noqa: E731
    c = tmodels.chebyshev_coeffs(f, order=24)
    np.testing.assert_array_equal(c, jmodels.chebyshev_coeffs(f, order=24))
    nb = n // b
    F, total, ovf = tmodels.chebyshev_apply(H, c, tau=0.0, pair_cap=nb**3, out_cap=nb * nb)
    assert not bool(ovf) and int(total) > 0
    w, v = np.linalg.eigh(H_d / bound)
    want = (v * f(w)) @ v.T
    assert np.abs(tx.to_dense(F).double().numpy() - want).max() < 1e-4


def test_chebyshev_planned_identical_jax_and_drift_flagged():
    n, b = 96, 16
    H_d = _cheb_h(n, b)
    bound = np.abs(H_d).sum(axis=1).max() * 1.05
    jh, th = _from_dense((H_d / bound).astype(np.float32), b)
    nb = n // b
    pc, oc, tau = nb**3, nb * nb, 1e-7
    c = tmodels.chebyshev_coeffs(lambda x: 1.0 / (1.0 + np.exp(6.0 * x)), order=12)
    plans = tmodels.plan_chebyshev(th, len(c), tau, pair_cap=pc, out_cap=oc)
    F0, t0, o0 = tmodels.chebyshev_apply(th, c, tau, pair_cap=pc, out_cap=oc)
    F1, t1, o1 = tmodels.chebyshev_apply(th, c, tau, pair_cap=pc, out_cap=oc, plans=plans)
    assert not bool(o0) and not bool(o1) and int(t0) == int(t1)
    _bitwise(F0, F1)
    JF, jt, jo = jmodels.chebyshev_apply(jh, c, tau, pair_cap=pc, out_cap=oc)
    _same(F1, JF)
    assert int(jt) == int(t0) and not bool(jo)
    # Another coefficient vector of the same length reuses the plans.
    c2 = tmodels.chebyshev_coeffs(lambda x: np.exp(-3 * x * x), order=12)
    F2, _, o2 = tmodels.chebyshev_apply(th, c2, tau, pair_cap=pc, out_cap=oc, plans=plans)
    assert not bool(o2)
    _bitwise(F2, tmodels.chebyshev_apply(th, c2, tau, pair_cap=pc, out_cap=oc)[0])
    d3 = (H_d / bound).astype(np.float32)
    d3[:b, -b:] = 0.02
    d3[-b:, :b] = 0.02
    H3 = tx.from_dense(torch.from_numpy((d3 + d3.T) / 2), block_size=b)
    assert bool(tmodels.chebyshev_apply(H3, c, tau, pair_cap=pc, out_cap=oc, plans=plans)[2])
    # A data drift with the same ids that changes truncation decisions.
    H4 = tx.scale(th, 0.01)
    plans4 = tmodels.plan_chebyshev(th, len(c), 1e-4, pair_cap=pc, out_cap=oc)
    F4p, _, o4 = tmodels.chebyshev_apply(H4, c, 1e-4, pair_cap=pc, out_cap=oc, plans=plans4)
    F4u, _, _ = tmodels.chebyshev_apply(H4, c, 1e-4, pair_cap=pc, out_cap=oc)
    same = torch.equal(tx.to_dense(F4p), tx.to_dense(F4u))
    assert same or bool(o4), "stale planned result differs yet unflagged"


# The planned add.


@pytest.mark.parametrize("cap", [None, 5])
def test_add_plan_matches_jax(cap):
    ja, ta = matrix_pair(6, 6, 16, 0.4, 30, pad=2)
    jb, tb = matrix_pair(6, 6, 16, 0.4, 31, pad=1)
    cap = ta.cap + tb.cap if cap is None else cap
    jp = jx.make_add_plan(ja.ids, jb.ids, cap)
    tp = tx.make_add_plan(ta.ids, tb.ids, cap)
    for f in dataclasses.fields(jp):
        np.testing.assert_array_equal(np_(getattr(tp, f.name)), np_(getattr(jp, f.name)), f.name)
    jc, jo = jx.add_planned(ja, jb, jp, alpha=0.5, beta=-2.0)
    tc, to = tx.add_planned(ta, tb, tp, alpha=0.5, beta=torch.tensor(-2.0))
    assert_same_matrix(tc, jc, rtol=0, atol=0)
    assert bool(to) == bool(jo) == (cap == 5)
    ref, _ = tx.add_with_info(ta, tb, alpha=0.5, beta=-2.0, cap=cap)
    assert torch.equal(ref.ids, tc.ids) and torch.equal(ref.data, tc.data)
    # A stale plan: B's ids moved at the same capacity.
    tb2 = tx.filter_blocks(tb, torch.arange(tb.cap) != 0)  # one block fewer
    assert tb2.cap == tb.cap and not torch.equal(tb2.ids, tb.ids)
    assert bool(tx.add_planned(ta, tb2, tp)[1])
    with pytest.raises(ValueError, match="capA\\+capB"):
        tx.add_planned(ta, tx.repack(tb, tb.cap + 1), tp)


# The entry step and the demo.


def _jax_entry():
    """__graft_entry__.entry(), with JAX's compilation-cache settings put
    back after its import changes them."""
    import importlib

    import jax

    saved = {k: getattr(jax.config, k) for k in JAX_CACHE_SETTINGS}
    try:
        return importlib.import_module("__graft_entry__").entry()
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def test_entry_matches_jax_entry():
    from hierarchical_block_sparse_lib_tpu_torch.entry import entry

    jfn, (jxx,) = _jax_entry()
    tfn, (txx,) = entry(device="cpu")
    assert_same_matrix(txx, jxx, rtol=0, atol=0)
    jy, js = jfn(jxx)
    ty, ts = tfn(txx)
    _same(ty, jy)
    for f in dataclasses.fields(js):
        g, w = np_(getattr(ts, f.name)), np.asarray(getattr(js, f.name))
        if f.name == "trace":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_purification_demo_reaches_the_projector():
    from hierarchical_block_sparse_lib_tpu_torch.scripts import purification_demo

    err = purification_demo.main(["1024"], device="cpu")
    assert err <= purification_demo.TOL
