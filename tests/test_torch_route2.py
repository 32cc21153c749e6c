"""Two-level (host x chip) routing (`parallel.route2`) against the JAX
package's `parallel/route2.py` at both factorizations of 8 shards, 2 x 4
and 4 x 2: Route2Plan and its bucketing field for field, the frozen
share structure, inter-host blocks at most the flat plan's, the product
against the flat routed one and the JAX package's single-device product,
and the two-level SP2 step, frozen and planned.  Ids, nnz and counters
exactly; payloads within 1e-5 of max|C|."""

import jax
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm, spgemm as jax_spgemm
from hierarchical_block_sparse_lib_tpu.parallel import dist as jdist, route2 as jroute2
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route, route2

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

FACTORS = [(2, 4), (4, 2)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def inputs():
    """The mix matrix, its distribution on both packages' flat meshes, and
    the JAX package's single-device product (once)."""
    assert len(jax.devices()) >= P
    n, b = 512, 16
    a = jx.from_dense(mix_dense(n, b, seed=3, extra=16), block_size=b)
    pc, oc = plan_spgemm(a, a)
    want, _ = jax_spgemm(a, a, pc, oc, backend="xla", alpha=-0.5)
    tm = dist.make_mesh(P, device="cpu")
    return a, jdist.distribute(a, jdist.make_mesh(P)), dist.distribute(to_port(a), tm), tm, want


@pytest.mark.parametrize("hc", FACTORS)
def test_route2_plan_matches_jax(inputs, hc):
    a, ad, tad, _, _ = inputs
    h, c = hc
    plan, want = route2.plan_route_2level(tad, tad, h, c), jroute2.plan_route_2level(ad, ad, h, c)
    assert_same_plan(plan, want)
    assert_same_plan(route2.bucket_plan_2level(plan), jroute2.bucket_plan_2level(want))
    assert plan.summary() == want.summary()
    flat = route.plan_route(tad, tad, P)
    assert plan.dcn_blocks <= plan.dcn_blocks_flat <= flat.blocks_routed
    assert plan.out_cap == flat.out_cap and plan.total_pairs == flat.total_pairs


@pytest.mark.parametrize("hc", FACTORS)
def test_2level_product(inputs, hc):
    """The two-level product equals the flat routed one (same ids per shard,
    data within 1e-5) and the JAX package's single-device product; the
    intra-host gathers move what the plan counts, padding included."""
    a, _, tad, tm, want = inputs
    h, c = hc
    mesh_hc = route2.make_mesh_2level(h, c, device="cpu")
    plan = route2.plan_route_2level(tad, tad, h, c)
    c2, st = route2.dist_spgemm_2level(tad, tad, mesh_hc, plan, alpha=-0.5)
    assert not bool(st["overflow"]) and not bool(st["plan_mismatch"])
    assert int(st["n_block_pairs"]) == plan_spgemm(a, a)[0]
    assert st["dcn_blocks"] <= st["dcn_blocks_flat"]
    cf, _ = route.dist_spgemm_routed(tad, tad, tm, route.plan_route(tad, tad, P), alpha=-0.5)
    for x, y in zip(c2.shards, cf.shards):
        assert torch.equal(x.ids, y.ids)
        assert rel_to_max(x.data.numpy(), y.data.numpy()) <= TOL
    assert_matches_single(c2, want)
    # Padded shares: each all_gather hands every chip its C-1 siblings'.
    gathered = [e[1] for e in mesh_hc.traffic.exchanges if e[0] == "all_gather"]
    assert gathered == [(c - 1) * P * s.shape[1] for s in plan.send_idx]


def test_freeze_route2_matches_jax(inputs):
    _, ad, tad, _, _ = inputs
    h, c = FACTORS[0]
    plan, jplan = route2.plan_route_2level(tad, tad, h, c), jroute2.plan_route_2level(ad, ad, h, c)
    got, want = route2.freeze_route2_plan(tad, tad, plan), jroute2.freeze_route2_plan(ad, ad, jplan)
    for k, per_cc in enumerate(want.stage_plans):
        for cc, sp in enumerate(per_cc):
            assert (sp is None) == (got.stage_plans[k][cc] is None)
            if sp is None:
                continue
            ids = np.asarray(sp.out_ids).reshape(h * c, -1)
            for d in range(h * c):
                np.testing.assert_array_equal(got.stage_plans[k][cc][d].out_ids.numpy(), ids[d])


@pytest.mark.parametrize("hc", FACTORS)
def test_2level_sp2_step(inputs, hc):
    """The two-level SP2 step matches the flat routed step (ids exactly,
    data within 1e-5); frozen equals unfrozen bitwise; a stale id
    structure is flagged."""
    h, c = hc
    n, b = 512, 16
    x = to_port(jx.from_dense(purifiable(mix_dense(n, b, seed=11, extra=24)), block_size=b))
    tm = dist.make_mesh(P, device="cpu")
    xd = dist.distribute(x, tm)
    mesh_hc = route2.make_mesh_2level(h, c, device="cpu")
    plan = route2.plan_route_2level(xd, xd, h, c)
    y0, s0 = route2.dist_sp2_step_2level(xd, mesh_hc, plan, 1e-7, target_trace=n / 4)
    y1, s1 = route2.dist_sp2_step_2level(xd, mesh_hc, route2.freeze_route2_plan(xd, xd, plan),
                                         1e-7, target_trace=n / 4, expect_ids=xd.stacked_ids())
    yf, sf = route.dist_sp2_step_routed(xd, tm, route.plan_route(xd, xd, P), 1e-7,
                                        target_trace=n / 4)
    for st in (s0, s1):
        assert not bool(st["overflow"]) and not bool(st["plan_mismatch"])
        assert int(st["n_block_pairs"]) == int(sf["n_block_pairs"])
        assert st["dcn_blocks"] <= st["dcn_blocks_flat"]
    np.testing.assert_allclose(float(s0["trace"]), float(sf["trace"]), rtol=1e-6)
    for p, q, r in zip(y0.shards, y1.shards, yf.shards):
        assert torch.equal(p.ids, q.ids) and torch.equal(p.data, q.data)
        assert torch.equal(p.ids, r.ids)
        assert rel_to_max(p.data.numpy(), r.data.numpy()) <= TOL
    stale = xd.stacked_ids().copy()
    stale[P - 1, 0] += 1
    _, st = route2.dist_sp2_step_2level(xd, mesh_hc, plan, 1e-7, target_trace=n / 4,
                                        expect_ids=stale)
    assert bool(st["plan_mismatch"])


def test_planned_2level_purification(monkeypatch):
    """plan_purify_2level then dist_purify_2level(plans=): no host
    replanning, bitwise equal to the unplanned run, and the same support
    as the flat routed purification with data within 1e-5."""
    h, c = FACTORS[0]
    n, b = 256, 16
    x = to_port(jx.from_dense(purifiable(mix_dense(n, b, seed=5, extra=8)), block_size=b))
    tm = dist.make_mesh(P, device="cpu")
    xd = dist.distribute(x, tm)
    mesh_hc = route2.make_mesh_2level(h, c, device="cpu")
    plans = route2.plan_purify_2level(xd, mesh_hc, 2, 1e-7, target_trace=n / 4)
    yu, _ = route2.dist_purify_2level(xd, mesh_hc, 2, 1e-7, target_trace=n / 4)

    def no_replan(*a, **k):
        raise AssertionError("plan_route_2level called during the planned run")

    monkeypatch.setattr(route2, "plan_route_2level", no_replan)
    yp, stats = route2.dist_purify_2level(xd, mesh_hc, 2, 1e-7, target_trace=n / 4, plans=plans)
    monkeypatch.undo()
    for st in stats:
        assert not bool(st["plan_mismatch"]) and not bool(st["overflow"])
    for p, q in zip(yu.shards, yp.shards):
        assert torch.equal(p.ids, q.ids) and torch.equal(p.data, q.data)
    yf, _ = route.dist_purify_routed(xd, tm, 2, 1e-7, target_trace=n / 4)
    g2, gf = dist.undistribute(yp), dist.undistribute(yf)
    k = int(gf.nnz)
    assert int(g2.nnz) == k
    assert torch.equal(g2.ids[:k], gf.ids[:k])
    assert rel_to_max(g2.data[:k].numpy(), gf.data[:k].numpy()) <= TOL
    with pytest.raises(ValueError, match="plan for"):
        route2.dist_spgemm_2level(xd, xd, route2.make_mesh_2level(c, h, device="cpu"),
                                  plans.step_plans[0])
