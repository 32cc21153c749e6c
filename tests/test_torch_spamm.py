"""The error-controlled multiply (SpAMM) in the port against the JAX
package: the norm filter of the symbolic phase, `spamm` on "xla",
"pallas" and "rows" (their plain versions on the CPU), the host planner
`plan_spamm` (C++, numpy, both loaders) and `spamm_error_bound`; then
tests/test_spamm.py's five tests on the port.

Thresholds of the cross-package comparisons lie halfway between two
sorted pair-norm products more than 1e-5 apart, so a keep decision cannot
flip between the packages by rounding."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops import spgemm as jsp
from hierarchical_block_sparse_lib_tpu.runtime import native as jnative
from hierarchical_block_sparse_lib_tpu_torch.ops import spgemm as tsp
from hierarchical_block_sparse_lib_tpu_torch.runtime import native as tnative

from torch_port_helpers import SENTINEL, assert_same_info, assert_same_matrix, np_


def _random_sparse(n, b, density, seed, scale_spread=True):
    """tests/test_spamm.py's input: blocks of wildly different norms."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < density)).astype(np.float32)
    if scale_spread:
        nb = n // b
        s = rng.uniform(-4, 1, (nb, nb))
        d = d * np.kron(10.0**s, np.ones((b, b))).astype(np.float32)
    return d


def _pair(d, b):
    return jx.from_dense(d, block_size=b), tx.from_dense(torch.from_numpy(d), block_size=b)


def _pair_products(A, B):
    """Sorted ||A_ik|| * ||B_kj|| over the enumerated pairs (host, f64)."""
    an = np.sqrt(tx.block_frob_squared(A).numpy().astype(np.float64))
    bn = np.sqrt(tx.block_frob_squared(B).numpy().astype(np.float64))
    prods = [p for _, _, p, _, _ in tnative._spamm_pairs(
        A.ids.numpy(), an, B.ids.numpy(), bn, A.nb_cols, B.nb_cols)]
    return np.sort(np.concatenate(prods))


def _midpoint_tau(A, B, q=0.5):
    """A threshold halfway between two neighbouring pair products near the
    q-quantile that lie more than 1e-5 (relative) apart."""
    p = _pair_products(A, B)
    m = int(q * len(p))
    for k in sorted(range(1, len(p)), key=lambda k: abs(k - m)):
        if p[k] > p[k - 1] * (1 + 1e-5):
            return float(0.5 * (p[k] + p[k - 1]))
    raise AssertionError("no gap between pair products")


def _assert_not_near(A, B, tau):
    """No pair product within 1e-5 (relative) of tau."""
    p = _pair_products(A, B)
    assert tau == 0.0 or np.min(np.abs(p / tau - 1)) > 1e-5


@pytest.fixture(scope="module")
def operands():
    da, db = _random_sparse(256, 16, 0.3, 0), _random_sparse(256, 16, 0.3, 1)
    ja, ta = _pair(da, 16)
    jb, tb = _pair(db, 16)
    return ja, ta, jb, tb, _midpoint_tau(ta, tb)


@pytest.mark.parametrize("syrk_upper", [False, True])
def test_symbolic_filter_matches_jax(operands, syrk_upper):
    ja, ta, jb, tb, tau = operands
    pc, _ = jsp.plan_spgemm(ja, jb)
    want = jx.spgemm_symbolic(ja, jb, pc + 7, tau=tau, filter_by_norm=True,
                              syrk_upper=syrk_upper)
    got = tx.spgemm_symbolic(ta, tb, pc + 7, tau=tau, filter_by_norm=True,
                             syrk_upper=syrk_upper)
    names = ("a_idx", "b_idx", "c_id", "total", "raw_total")
    for name, g, w in zip(names, got, want):
        assert np_(g).dtype == np_(w).dtype, name
        np.testing.assert_array_equal(np_(g), np_(w), err_msg=name)
    assert 0 < int(got[3]) < int(got[4]) == pc
    plan_t = tx.make_plan(ta, tb, pc, tau=tau, filter_by_norm=True)
    plan_j = jx.make_plan(ja, jb, pc, tau=tau, filter_by_norm=True)
    for name in names:
        np.testing.assert_array_equal(np_(getattr(plan_t, name)), np_(getattr(plan_j, name)))


@pytest.mark.parametrize("backend", ["xla", "pallas", "rows"])
def test_spamm_matches_jax(operands, backend):
    """The port's spamm on each backend against the JAX package's (its
    CPU "auto" runs "xla"): ids and MultiplyInfo exactly, payloads within
    1e-5 ("highest")."""
    ja, ta, jb, tb, tau = operands
    pc, _, mbr, mcr = jsp.plan_spgemm_ex(ja, jb)
    pc_f, oc_f = jsp.plan_spamm(ja, jb, tau)
    assert (pc_f, oc_f) == tsp.plan_spamm(ta, tb, tau)
    kw = dict(pair_cap=pc, out_cap=oc_f, gemm_cap=pc_f)
    jc, ji = jx.spamm(ja, jb, tau, **kw)
    rows = dict(row_caps=(mbr, mcr)) if backend == "rows" else {}
    tc, ti = tx.spamm(ta, tb, tau, backend=backend, **rows, **kw)
    scale = float(np.abs(np.asarray(jc.data)).max())
    assert_same_matrix(tc, jc, rtol=1e-5, atol=1e-5 * scale)
    assert_same_info(ti, ji)
    assert int(ti.n_block_pairs) == pc_f < pc


def test_spamm_error_bound_matches_jax(operands):
    """Given the same block norms the two bounds agree within 1e-12; each
    package's own f32 norms differ in the last bit (sums of squares taken
    in another order), so the matrix-level bounds agree within 1e-6."""
    ja, ta, jb, tb, tau = operands
    an = np.sqrt(np.asarray(jx.block_frob_squared(ja)))
    bn = np.sqrt(np.asarray(jx.block_frob_squared(jb)))
    for t in (0.0, tau, 10 * tau):
        want = jsp.spamm_error_bound(ja, jb, t)
        same_norms = tnative.spamm_error_bound(
            ta.ids.numpy(), an, tb.ids.numpy(), bn, ta.nb_cols, tb.nb_cols, t)
        assert same_norms == pytest.approx(want, rel=1e-12, abs=0)
        assert tsp.spamm_error_bound(ta, tb, t) == pytest.approx(want, rel=1e-6, abs=0)
    assert tsp.spamm_error_bound(ta, tb, tau) > 0


@pytest.mark.parametrize("backend", ["groups", "fine"])
def test_filter_refused_by_groups_and_fine(backend):
    _, ta = _pair(_random_sparse(128, 32, 0.3, 5, scale_spread=False), 32)
    with pytest.raises(ValueError, match="filter_by_norm"):
        tx.spgemm(ta, ta, 64, 16, tau=0.1, filter_by_norm=True, backend=backend,
                  row_caps=(4, 4), group_caps=(2, 8, 8, 8))


def test_planned_spamm_bitwise_and_norm_drift_flagged(operands):
    """A plan built with the filter: the planned call equals the planless
    one bitwise; data that changes a keep decision sets plan_mismatch."""
    _, ta, _, tb, tau = operands
    pc, _ = tsp.plan_spgemm(ta, tb)
    pc_f, oc_f = tsp.plan_spamm(ta, tb, tau)
    plan = tx.make_plan(ta, tb, pc, tau=tau, filter_by_norm=True)
    kw = dict(pair_cap=pc, out_cap=oc_f, gemm_cap=pc_f, backend="xla")
    c0, i0 = tx.spamm(ta, tb, tau, **kw)
    c1, i1 = tx.spamm(ta, tb, tau, plan=plan, **kw)
    assert torch.equal(c0.ids, c1.ids) and torch.equal(c0.data, c1.data)
    assert not bool(i1.plan_mismatch)
    # Same ids, one surviving pair's A block scaled below the threshold.
    a_low = ta.with_data(ta.data.clone())
    a_low.data[int(plan.a_idx[0])] *= 1e-6
    _, i2 = tx.spamm(a_low, tb, tau, plan=plan, **kw)
    assert bool(i2.plan_mismatch)


@pytest.mark.parametrize("tau", [0.0, 0.5, 2.0, 1e9])
def test_plan_spamm_cpp_numpy_and_loaders_agree(tau):
    """tests/test_native.py's plan_spamm check on the port's loader, and
    against the JAX package's loader."""
    rng = np.random.default_rng(8)
    nb = 20

    def ids(n, cap, seed):
        r = np.random.default_rng(seed)
        v = np.sort(r.choice(nb * nb, n, replace=False)).astype(np.int32)
        return np.concatenate([v, np.full(cap - n, SENTINEL, np.int32)])

    a_ids, b_ids = ids(50, 64, 8), ids(70, 80, 9)
    a_norms = np.where(a_ids != SENTINEL, rng.uniform(0.1, 3.0, a_ids.size), 0).astype(np.float32)
    b_norms = np.where(b_ids != SENTINEL, rng.uniform(0.1, 3.0, b_ids.size), 0).astype(np.float32)
    assert tnative.have_native()
    got = tnative.plan_spamm(a_ids, a_norms, b_ids, b_norms, nb, nb, nb, tau)
    assert got == tnative.plan_spamm_numpy(a_ids, a_norms, b_ids, b_norms, nb, nb, tau)
    assert got == jnative.plan_spamm(a_ids, a_norms, b_ids, b_norms, nb, nb, nb, tau)
    assert tnative.spamm_error_bound(a_ids, a_norms, b_ids, b_norms, nb, nb, tau) == (
        jnative.spamm_error_bound(a_ids, a_norms, b_ids, b_norms, nb, nb, tau))
    if tau == 0.0:
        assert got == tnative.plan_spgemm(a_ids, b_ids, nb, nb, nb)
    if tau == 1e9:
        assert got == (0, 0)


# tests/test_spamm.py, on the port.


def _host_bound(A, B, tau):
    """The skipped pairs' norm products, summed by a plain loop."""
    an = np.sqrt(tx.block_frob_squared(A).numpy())
    bn = np.sqrt(tx.block_frob_squared(B).numpy())
    ar, ac = (A.ids // A.nb_cols).numpy(), (A.ids % A.nb_cols).numpy()
    br = (B.ids // B.nb_cols).numpy()
    bound = 0.0
    for i in range(len(ar)):
        if A.ids[i] == SENTINEL:
            continue
        for j in range(len(br)):
            if B.ids[j] != SENTINEL and br[j] == ac[i] and an[i] * bn[j] <= tau:
                bound += an[i] * bn[j]
    return bound


@pytest.mark.parametrize("tau", [1e-3, 1e-1])
def test_spamm_error_bounded(tau):
    da, db = _random_sparse(256, 16, 0.3, 0), _random_sparse(256, 16, 0.3, 1)
    _, A = _pair(da, 16)
    _, B = _pair(db, 16)
    _assert_not_near(A, B, tau)
    pc, oc = tsp.plan_spgemm(A, B)
    pc_f, oc_f = tsp.plan_spamm(A, B, tau)
    assert pc_f <= pc and oc_f <= oc
    C, info = tx.spamm(A, B, tau, pair_cap=pc, out_cap=max(oc_f, 1), gemm_cap=max(pc_f, 1))
    assert not bool(info.pair_overflow) and not bool(info.out_overflow)
    assert int(info.n_block_pairs) == pc_f
    err = np.linalg.norm(tx.to_dense(C).numpy() - da @ db, "fro")
    bound = _host_bound(A, B, tau)
    assert err <= bound * (1 + 1e-4) + 1e-6
    assert err > 0 or pc_f == pc


def test_spamm_tau_zero_is_exact():
    da = _random_sparse(128, 16, 0.2, 3, scale_spread=False)
    ja, A = _pair(da, 16)
    pc, oc = tsp.plan_spgemm(A, A)
    C, info = tx.spamm(A, A, 0.0, pair_cap=pc, out_cap=oc)
    np.testing.assert_allclose(tx.to_dense(C).numpy(), da @ da, rtol=2e-5, atol=2e-5)
    assert int(info.n_block_pairs) == pc
    jc, ji = jx.spamm(ja, ja, 0.0, pair_cap=pc, out_cap=oc)
    assert_same_matrix(C, jc)
    assert_same_info(info, ji)


def test_spamm_rows_backend_matches_xla():
    """The row-panel path's skip (its plain version here) == the filtered
    torch path, and both == the JAX package's row-panel kernel (interpret
    mode)."""
    n, b, tau = 192, 8, 5e-2
    da, db = _random_sparse(n, b, 0.3, 10), _random_sparse(n, b, 0.3, 11)
    ja, A = _pair(da, b)
    jb, B = _pair(db, b)
    _assert_not_near(A, B, tau)
    pc, oc, mbr, mcr = tsp.plan_spgemm_ex(A, B)
    kw = dict(pair_cap=pc, out_cap=oc, tau=tau, filter_by_norm=True)
    C_r, info_r = tx.spgemm(A, B, backend="rows", row_caps=(mbr, mcr), **kw)
    C_x, info_x = tx.spgemm(A, B, backend="xla", **kw)
    assert int(info_r.n_block_pairs) == int(info_x.n_block_pairs) < pc
    np.testing.assert_allclose(tx.to_dense(C_r).numpy(), tx.to_dense(C_x).numpy(),
                               rtol=1e-5, atol=1e-5)
    jc, ji = jx.spgemm(ja, jb, backend="rows", row_caps=(mbr, mcr), **kw)
    assert_same_matrix(C_r, jc)
    assert_same_info(info_r, ji)


def test_spamm_overflow_reported_when_gemm_cap_too_small():
    _, A = _pair(_random_sparse(128, 16, 0.3, 4, scale_spread=False), 16)
    pc, oc = tsp.plan_spgemm(A, A)
    assert pc > 2
    _, info = tx.spamm(A, A, 0.0, pair_cap=pc, out_cap=oc, gemm_cap=2)
    assert bool(info.pair_overflow)


def test_spamm_error_bound_certificate():
    n, b, tau = 192, 16, 5e-2
    da, db = _random_sparse(n, b, 0.3, 20), _random_sparse(n, b, 0.3, 21)
    _, A = _pair(da, b)
    _, B = _pair(db, b)
    _assert_not_near(A, B, tau)
    pc, oc = tsp.plan_spgemm(A, B)
    bound = tsp.spamm_error_bound(A, B, tau)
    C, info = tx.spamm(A, B, tau, pair_cap=pc, out_cap=max(oc, 1))
    err = np.linalg.norm(
        tx.to_dense(C).numpy().astype(np.float64) - da.astype(np.float64) @ db.astype(np.float64),
        "fro",
    )
    assert err <= bound * (1 + 1e-4) + 1e-6
    assert bound > 0 and int(info.n_block_pairs) < pc
