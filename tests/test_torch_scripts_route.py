"""The port's ablation scripts `bench_scatter_accum`, `bench_band_route`,
`bench_planner_scaling` and `b5_route2_evidence`
(`hierarchical_block_sparse_lib_tpu_torch/scripts/`) on the CPU at cut
sizes, against the JAX package on the same numpy-built inputs: each
`main`'s last stdout line (counters, plans, traffic, checks) and the
results behind it, ids and counters exactly, payloads within 1e-5.  Then
the shared protocol (`scripts/ablation.py`): a difference inside the
spread of its terms is said to be no measured cost, and every script
exits 2 without a card."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.ops import band as jband
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex as jplan_spgemm_ex
from hierarchical_block_sparse_lib_tpu.parallel import (
    dist as jdist,
    route as jroute,
    route2 as jroute2,
)
from hierarchical_block_sparse_lib_tpu.utils import generators as jgen
import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route, route2
from hierarchical_block_sparse_lib_tpu_torch.scripts import (
    ablation,
    b5_route2_evidence,
    bench_band_route,
    bench_planner_scaling,
    bench_scatter_accum,
    bench_symmetric,
    profile_b3,
    profile_routed_1dev,
    profile_scan,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import b5_mix

from torch_port_helpers import import_jax_script, rel_to_max, torch_threads

DEV = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = (profile_b3, profile_scan, bench_symmetric, profile_routed_1dev, bench_scatter_accum,
           bench_band_route, bench_planner_scaling, b5_route2_evidence)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def jax_mesh(p):
    return Mesh(np.asarray(jax.devices()[:p]), ("p",))


# -- bench_scatter_accum ------------------------------------------------------------

def test_bench_scatter_accum_matches_jax(capsys):
    """Both formulations against the JAX script's (scripts/
    bench_scatter_accum.py:61-65) on the same numpy operands: equal."""
    union, stage, b = 64, 20, 16
    assert bench_scatter_accum.main([], device=DEV, union=union, stage=stage, b=b) == 0
    rec = last_line(capsys)
    assert rec["checks"] == {"gather-add and scatter-add equal": True}
    assert rec["parts"]["gather-add"]["ms"] is None and rec["launches"] == {}
    assert rec["floors"]["union_ms"] == pytest.approx(2 * union * b * b * 4 / 3.35e12 * 1e3)
    assert rec["floors"]["touched_ms"] == pytest.approx(2 * stage * b * b * 4 / 3.35e12 * 1e3)
    c0, prod, idx, inv = bench_scatter_accum.operands(union, stage, b, DEV)
    jc0, jprod = jnp.asarray(c0.numpy()), jnp.asarray(prod.numpy())
    want_g = np.asarray(jc0 + jnp.take(jprod, jnp.asarray(inv.numpy()), axis=0, mode="fill",
                                       fill_value=0))
    want_s = np.asarray(jc0.at[jnp.asarray(idx.numpy())].add(jprod))
    np.testing.assert_array_equal(want_g, want_s)
    got = c0.clone().index_add_(0, idx.long(), prod).numpy()
    np.testing.assert_array_equal(got, want_s)


def test_bench_scatter_accum_configured_floors():
    """The floors at the configured shapes: the union buffer read and
    written once 0.173 ms, the touched blocks 0.048 ms, at 3.35 TB/s."""
    union_b, touched_b = 2 * 4415 * 128 * 128 * 4, 2 * 1231 * 128 * 128 * 4
    assert round(union_b / 3.35e12 * 1e3, 3) == 0.173
    assert round(touched_b / 3.35e12 * 1e3, 3) == 0.048


# -- bench_band_route ------------------------------------------------------------

def test_bench_band_route_matches_jax(capsys):
    n, bw = 512, 16
    assert bench_band_route.main([], device=DEV, n=n, bw=bw) == 0
    rec = last_line(capsys)
    assert all(rec["checks"].values())
    assert set(rec["parts"]) == {"band_from_blocks", "band_mm", "band_to_blocks", "band route",
                                 "block path"}
    r, c, v = jgen.banded_coo(n, bw, seed=0)
    ja = jx.from_coo(r, c, v, n, block_size=16)
    pc, oc, _, _ = jplan_spgemm_ex(ja, ja)
    assert (rec["counters"]["blocks"], rec["counters"]["pairs"], rec["counters"]["out"]) == (
        int(ja.nnz), pc, oc)
    assert rec["counters"]["backend"] == "fine"  # b = 16 with row caps, as acceptance's b1
    jab = jband.band_from_blocks(ja, bw)
    want = np.asarray(jband.band_to_dense(jband.band_mm(jab, jab)))
    a = hbsm.from_coo(r, c, v, n, block_size=16, device=DEV)
    ab = hbsm.band_from_blocks(a, bw)
    got = hbsm.band_to_dense(hbsm.band_mm(ab, ab)).numpy()
    assert rel_to_max(got, want) <= 1e-5
    back = hbsm.to_dense(hbsm.band_to_blocks(hbsm.band_mm(ab, ab), block_size=16)).numpy()
    assert rel_to_max(back, want) <= 1e-5


# -- bench_planner_scaling ------------------------------------------------------------

@pytest.fixture(scope="module")
def planner_run():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench_planner_scaling.main([], device=DEV, nb=128, max_p=8) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("p", [2, 4, 8])
def test_planner_scaling_flat_matches_jax(p, planner_run):
    """At P <= 8, the tests' virtual device count: each flat plan's kept
    stages and routed blocks as the JAX planner's."""
    ja = import_jax_script("b5_route_evidence").b5_mix(128, 8)
    jad = jdist.distribute(ja, jax_mesh(p))
    plan = jroute.plan_route(jad, jad, p)
    assert planner_run["counters"]["flat"][str(p)] == [len(plan.stages), plan.blocks_routed]
    assert planner_run["max_p"] == 8 and planner_run["growth"] == {"plan_route": None,
                                                                   "freeze": None}


def test_planner_scaling_two_level_matches_jax(planner_run):
    ja = import_jax_script("b5_route_evidence").b5_mix(128, 8)
    jad = jdist.distribute(ja, jax_mesh(8))
    p2 = jroute2.plan_route_2level(jad, jad, 2, 4)
    assert planner_run["counters"]["two"] == {"2x4": [p2.dcn_blocks, p2.dcn_blocks_flat,
                                                      p2.ici_blocks]}
    assert set(planner_run["parts"]) == {"plan_route P=2", "freeze P=2", "plan_route P=4",
                                         "freeze P=4", "plan_route P=8", "freeze P=8",
                                         "plan_route_2level 2x4"}


def test_planner_full_b5_2x4_row_matches_docs():
    """The port's planners on the full B5 grid, ``b5_mix(1024, 8)`` at 2x4,
    against docs/B5_ROUTE.md:70 (DCN 3 340, flat inter-host 4 627, ICI
    25 482, flat-routed 8 176, ring 36 078)."""
    a = b5_mix(1024, 8, device=DEV)
    ad = dist.distribute(a, dist.make_mesh(8, device=DEV))
    p2 = route2.plan_route_2level(ad, ad, 2, 4)
    pf = route.plan_route(ad, ad, 8)
    got = (p2.dcn_blocks, p2.dcn_blocks_flat, p2.ici_blocks, pf.blocks_routed, pf.blocks_ring)
    assert got == b5_route2_evidence.EXPECTED[(1024, 8)]["2x4"] == (3340, 4627, 25482, 8176,
                                                                     36078)
    assert bench_planner_scaling.growth([2, 4, 8, 16], [1.0, 2.0, 4.0, 16.0]) == pytest.approx(2.0)


# -- b5_route2_evidence ------------------------------------------------------------

def docs_digest():
    with open(os.path.join(REPO, "docs", "B5_ROUTE.md"), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_b5_route2_evidence_matches_jax(capsys, tmp_path):
    """At a cut grid: the 2x4 and 4x2 rows against the JAX planners (the
    tests' 8 virtual devices), the anchor clean, docs/B5_ROUTE.md left
    byte-identical, and the table written only to --out."""
    before = docs_digest()
    out = tmp_path / "table.md"
    assert b5_route2_evidence.main(["--out", str(out)], device=DEV, nb=128) == 0
    assert docs_digest() == before
    rec = last_line(capsys)
    assert all(rec["checks"].values()) and rec["counters"]["anchor_rel_err"] < 1e-5
    ja = import_jax_script("b5_route_evidence").b5_mix(128, 8)
    jad = jdist.distribute(ja, jax_mesh(8))
    pf = jroute.plan_route(jad, jad, 8)
    for h, c in ((2, 4), (4, 2)):
        p2 = jroute2.plan_route_2level(jad, jad, h, c)
        assert rec["counters"]["rows"][f"{h}x{c}"] == [
            p2.dcn_blocks, p2.dcn_blocks_flat, p2.ici_blocks, pf.blocks_routed, pf.blocks_ring]
    rows = {k: tuple(v) for k, v in rec["counters"]["rows"].items()}
    assert out.read_text() == b5_route2_evidence.table(rows, rec["counters"]["anchor_rel_err"])


def test_b5_route2_table_matches_docs():
    """`table` renders the configured rows as docs/B5_ROUTE.md:70-73 has
    them."""
    rows = b5_route2_evidence.EXPECTED[(1024, 8)]
    with open(os.path.join(REPO, "docs", "B5_ROUTE.md")) as f:
        doc = f.read()
    for line in b5_route2_evidence.table(rows, 0.0).splitlines()[:6]:
        assert line in doc, line


# -- the shared protocol ------------------------------------------------------------

def test_difference_against_the_spread():
    """A difference whose magnitude is within the summed spread of its
    terms is reported as no measured cost; device times subtract."""
    run = ablation.Run("unit", torch.device("cpu"))
    run.on_card = True
    run.parts = {
        "a": dict(ms=2.0, min=1.5, max=3.0, device_ms=0.5),
        "b": dict(ms=1.0, min=0.9, max=1.1, device_ms=0.2),
        "c": dict(ms=0.5, min=0.45, max=0.55, device_ms=None),
    }
    d = run.difference("a - b", ["a"], ["b"])
    assert d == dict(ms=1.0, spread=pytest.approx(1.7), within_spread=True,
                     device_ms=pytest.approx(0.3))
    d = run.difference("(b - c) / 2", ["b"], ["c"], scale=0.5)
    assert d["ms"] == pytest.approx(0.25) and d["spread"] == pytest.approx(0.15)
    assert d["within_spread"] is False and d["device_ms"] is None
    d = run.difference("a per step", ["a"], scale=0.25)
    assert d == dict(ms=0.5, spread=pytest.approx(0.375), within_spread=None,
                     device_ms=pytest.approx(0.125))


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_script_without_a_card_exits_2(script, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main([]) == 2
    assert capsys.readouterr().out == ""
