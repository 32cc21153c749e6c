"""The sparsity-aware block router (`parallel.route`) against the JAX
package's `parallel/route.py` on its 8 virtual CPU devices: RoutePlan and
bucket_plan field for field, the frozen stage structure and the aligned
decision, the routed product and its counters, frozen == planned bitwise,
a stale plan flagged, and routed SP2 and the planned routed purification
against the JAX package's single-device steps.  Each JAX computation is
made once per module.  Ids, nnz and counters exactly; payloads within
1e-5 of max|C|."""

import inspect

import jax
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.models.purification import sp2_step as jax_sp2_step
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.parallel import dist as jdist, route as jroute
from hierarchical_block_sparse_lib_tpu_torch.convert import dist_to_numpy
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import spgemm
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route

from torch_port_helpers import (
    torch_threads,
    assert_matches_single,
    assert_same_plan,
    mix_dense,
    purifiable,
    rel_to_max,
    to_port,
)

P = 8
TOL = 1e-5  # payloads, relative to max|C|
SENT = np.iinfo(np.int32).max


# (n, b, seed, random blocks): "banded" keeps 3 of 8 stages, "mix" 7.
CASES = {"banded": (512, 16, 7, 0), "mix": (512, 16, 7, 12)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= P
    return jdist.make_mesh(P), dist.make_mesh(P, device="cpu")


@pytest.fixture(scope="module")
def cases(meshes):
    """Per case: the JAX matrix and its distribution on both meshes."""
    jm, tm = meshes
    out = {}
    for name, (n, b, seed, extra) in CASES.items():
        a = jx.from_dense(mix_dense(n, b, seed, extra), block_size=b)
        out[name] = (a, jdist.distribute(a, jm), dist.distribute(to_port(a), tm))
    return out


@pytest.fixture(scope="module")
def jax_routed(meshes, cases):
    """The JAX package's routed product of the banded case (one call)."""
    jm, _ = meshes
    _, ad, _ = cases["banded"]
    return jroute.dist_spgemm_routed(ad, ad, jm, jroute.plan_route(ad, ad, P), backend="xla")


def test_public_names_match_jax():
    """Every public name the JAX parallel modules define has a counterpart
    of the same kind in the port, under the same name."""
    import hierarchical_block_sparse_lib_tpu.parallel as jpar
    import hierarchical_block_sparse_lib_tpu_torch.parallel as tpar

    for mod in ("dist", "dist2d", "route", "route2"):
        jmod, tmod = getattr(jpar, mod), getattr(tpar, mod)
        names = [k for k, v in vars(jmod).items() if not k.startswith("_")
                 and getattr(v, "__module__", None) == jmod.__name__]
        assert names, mod
        for k in names:
            assert hasattr(tmod, k), f"{mod}.{k}"
            assert inspect.isclass(getattr(tmod, k)) == inspect.isclass(getattr(jmod, k)), k


@pytest.mark.parametrize("case", list(CASES))
def test_route_plan_matches_jax(cases, case):
    a, ad, tad = cases[case]
    plan, want = route.plan_route(tad, tad, P), jroute.plan_route(ad, ad, P)
    assert_same_plan(plan, want)
    assert_same_plan(route.bucket_plan(plan), jroute.bucket_plan(want))
    assert plan.summary() == want.summary()
    assert plan.total_pairs == plan_spgemm(a, a)[0]


def test_freeze_matches_jax(cases):
    """The frozen stage structure (each stage's union ids per shard, both
    regimes) and the aligned decision equal the JAX package's."""
    _, ad, tad = cases["banded"]
    plan, jplan = route.plan_route(tad, tad, P), jroute.plan_route(ad, ad, P)
    for aligned in (False, True):
        got = route.freeze_route_plan(tad, tad, plan, aligned=aligned)
        want = jroute.freeze_route_plan(ad, ad, jplan, aligned=aligned)
        assert got.aligned == want.aligned == aligned
        for k, sp in enumerate(want.stage_plans):
            for d in range(P):
                for f in ("out_ids", "c_id", "total"):
                    np.testing.assert_array_equal(getattr(got.stage_plans[k][d], f).numpy(),
                                                  np.asarray(getattr(sp, f))[d], err_msg=f)
    # The default decision: no row-panel kernel at b = 16 in either package.
    assert route.freeze_route_plan(tad, tad, plan).aligned is False
    assert jroute.freeze_route_plan(ad, ad, jplan).aligned is False


def test_aligned_decision_at_b128(meshes):
    """At b = 128 with two or more stages both packages take the aligned
    regime; with one kept stage neither does."""
    jm, tm = meshes
    rng = np.random.default_rng(3)
    nb, b = 16, 128
    band = [i * nb + j for i in range(nb) for j in range(nb) if abs(i - j) <= 1]
    for ids in (np.array(band, np.int32),
                np.arange(nb, dtype=np.int32) * (nb + 1)):  # diagonal: one stage
        data = rng.standard_normal((ids.size, b, b)).astype(np.float32)
        a = jx.BlockMatrix(ids=jax.numpy.asarray(ids), data=jax.numpy.asarray(data),
                           nnz=jax.numpy.asarray(ids.size, jax.numpy.int32),
                           n_rows=nb * b, n_cols=nb * b, block_size=b)
        ad, tad = jdist.distribute(a, jm), dist.distribute(to_port(a), tm)
        jplan, plan = jroute.plan_route(ad, ad, P), route.plan_route(tad, tad, P)
        assert_same_plan(plan, jplan)
        got = route.freeze_route_plan(tad, tad, plan).aligned
        assert got == jroute.freeze_route_plan(ad, ad, jplan).aligned == (len(plan.stages) >= 2)


def test_routed_matches_jax(meshes, cases, jax_routed):
    _, tm = meshes
    _, ad, tad = cases["banded"]
    jc, jst = jax_routed
    c, st = route.dist_spgemm_routed(tad, tad, tm, route.plan_route(tad, tad, P), backend="xla")
    for k in ("n_block_pairs", "overflow", "plan_mismatch"):
        assert int(st[k]) == int(jst[k]), k
    np.testing.assert_array_equal(st["per_device_pairs"].numpy(),
                                  np.asarray(jst["per_device_pairs"]))
    for k in ("blocks_routed", "blocks_ring", "n_stages", "n_stages_skipped"):
        assert st[k] == jst[k], k
    got, want = dist_to_numpy(c), dist_to_numpy(jc)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["nnz"], want["nnz"])
    assert rel_to_max(got["data"], want["data"]) <= TOL


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_routed_matches_single_shard(meshes, cases, case, backend):
    """The routed product gathered back equals the single-device product of
    the port: ids exactly, data within 1e-5; alpha applied."""
    _, tm = meshes
    a, _, tad = cases[case]
    ta = to_port(a)
    pc, oc = plan_spgemm(a, a)
    ref, _ = spgemm(ta, ta, pc, oc, backend="xla", alpha=-0.5)
    plan = route.plan_route(tad, tad, P)
    c, st = route.dist_spgemm_routed(tad, tad, tm, plan, alpha=-0.5, backend=backend)
    assert not bool(st["overflow"]) and int(st["n_block_pairs"]) == pc
    assert int(st["per_device_pairs"].sum()) == pc
    got = dist.undistribute(c)
    assert int(got.nnz) == int(ref.nnz) == oc
    np.testing.assert_array_equal(got.ids[:oc].numpy(), ref.ids.numpy())
    assert rel_to_max(got.data[:oc].numpy(), ref.data.numpy()) <= TOL


@pytest.mark.parametrize("case", list(CASES))
def test_frozen_equals_planned(meshes, cases, case):
    """Frozen (unaligned) == planned bitwise; the aligned regime keeps the
    same valid ids per shard, its data within 1e-5."""
    _, tm = meshes
    _, _, tad = cases[case]
    plan = route.plan_route(tad, tad, P)
    c0, s0 = route.dist_spgemm_routed(tad, tad, tm, plan)
    c1, s1 = route.dist_spgemm_routed(tad, tad, tm, route.freeze_route_plan(tad, tad, plan,
                                                                             aligned=False))
    assert not bool(s1["overflow"]) and not bool(s1["plan_mismatch"])
    for x, y in zip(c0.shards, c1.shards):
        assert torch.equal(x.ids, y.ids) and torch.equal(x.data, y.data)
    frozen = route.freeze_route_plan(tad, tad, plan, aligned=True)
    c2, s2 = route.dist_spgemm_routed(tad, tad, tm, frozen)
    assert not bool(s2["overflow"]) and not bool(s2["plan_mismatch"])
    assert int(s2["n_block_pairs"]) == int(s0["n_block_pairs"])
    g0, g2 = dist_to_numpy(c0), dist_to_numpy(c2)
    for d in range(P):
        v0, v2 = g0["ids"][d] != SENT, g2["ids"][d] != SENT
        np.testing.assert_array_equal(g0["ids"][d][v0], g2["ids"][d][v2])
        assert rel_to_max(g2["data"][d][v2], g0["data"][d][v0]) <= TOL


def test_stale_frozen_plan_flagged(meshes, cases):
    """A frozen plan applied to another structure at the same capacities
    sets plan_mismatch (a wrong result is never silent); an empty stage
    list runs."""
    import dataclasses

    _, tm = meshes
    _, _, tad = cases["banded"]
    plan = route.plan_route(tad, tad, P)
    for aligned in (False, True):
        frozen = route.freeze_route_plan(tad, tad, plan, aligned=aligned)
        s0 = tad.shards[0]
        ids = s0.ids.clone()
        ids[0] = ids[0] - 1 if int(ids[0]) % tad.nb_cols else ids[0] + 1
        ids, _ = torch.sort(ids)
        stale = dist.with_shards(tad, [dataclasses.replace(s0, ids=ids)] + list(tad.shards[1:]))
        _, st = route.dist_spgemm_routed(stale, stale, tm, frozen)
        assert bool(st["plan_mismatch"]), aligned


@pytest.fixture(scope="module")
def sp2_case(meshes):
    """A purifiable iterate on both packages and the JAX package's
    single-device SP2 step on it."""
    jm, tm = meshes
    n, b = 512, 16
    x = jx.from_dense(purifiable(mix_dense(n, b, seed=11, extra=24)), block_size=b)
    pc, oc = plan_spgemm(x, x)
    want = jax_sp2_step(x, 1e-7, pair_cap=pc, out_cap=oc, target_trace=n / 4, backend="xla",
                        cap=oc)
    return x, dist.distribute(to_port(x), tm), want, n


@pytest.mark.parametrize("mode", ["planned", "frozen", "frozen aligned"])
def test_routed_sp2_matches_jax(meshes, sp2_case, mode):
    _, tm = meshes
    x, xd, (want, wst), n = sp2_case
    plan = route.plan_route(xd, xd, P)
    if mode != "planned":
        plan = route.freeze_route_plan(xd, xd, plan, aligned=mode == "frozen aligned")
    y, st = route.dist_sp2_step_routed(xd, tm, plan, 1e-7, target_trace=n / 4,
                                       expect_ids=xd.stacked_ids())
    assert not bool(st["overflow"]) and not bool(st["plan_mismatch"])
    assert int(st["n_block_pairs"]) == int(wst.n_block_pairs)
    np.testing.assert_allclose(float(st["trace"]), float(wst.trace), rtol=1e-6)
    assert_matches_single(y, want)


def test_routed_sp2_checks_expected_ids(meshes, sp2_case):
    _, tm = meshes
    _, xd, _, n = sp2_case
    plan = route.plan_route(xd, xd, P)
    stale = xd.stacked_ids().copy()
    stale[0, 0] += 1
    _, st = route.dist_sp2_step_routed(xd, tm, plan, 1e-7, target_trace=n / 4, expect_ids=stale)
    assert bool(st["plan_mismatch"])
    with pytest.raises(ValueError, match="plan built for"):
        route.dist_sp2_step_routed(xd, tm, plan, 1e-7, expect_ids=stale[:, :-1])


def test_planned_routed_purification(meshes, sp2_case, monkeypatch):
    """plan_purify_routed records the steps; the planned run replans
    nothing and equals the unplanned run bitwise, and both follow the
    JAX package's single-device steps."""
    _, tm = meshes
    x, xd, (y1, _), n = sp2_case
    steps, tau = 2, 1e-7
    plans = route.plan_purify_routed(xd, tm, steps, tau, target_trace=n / 4)
    assert plans.n_steps == steps and all(p.aligned is False for p in plans.step_plans)
    yu, _ = route.dist_purify_routed(xd, tm, steps, tau, target_trace=n / 4)

    def no_replan(*a, **k):
        raise AssertionError("plan_route called during the planned run")

    monkeypatch.setattr(route, "plan_route", no_replan)
    yp, stats = route.dist_purify_routed(xd, tm, steps, tau, target_trace=n / 4, plans=plans)
    monkeypatch.undo()
    for st in stats:
        assert not bool(st["plan_mismatch"]) and not bool(st["overflow"])
    for a, b in zip(yu.shards, yp.shards):
        assert torch.equal(a.ids, b.ids) and torch.equal(a.data, b.data)
    pc, oc = plan_spgemm(y1, y1)
    want, _ = jax_sp2_step(y1, tau, pair_cap=pc, out_cap=oc, target_trace=n / 4, backend="xla",
                           cap=oc)
    assert_matches_single(yp, want)
    with pytest.raises(ValueError, match="plans cover"):
        route.dist_purify_routed(xd, tm, 3, tau, plans=plans)
