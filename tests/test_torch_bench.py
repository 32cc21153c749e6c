"""The port's bench (`hierarchical_block_sparse_lib_tpu_torch/bench.py`) on
the CPU at cut sizes: each stage function's counters against what the JAX
package computes on the same numpy-built input (bench.py's own
generators): pairs, output blocks, row caps, group caps, fine pairs, the
leaf counter, kpack's inflation and tiles, `profile_purify`'s per-step
pairs / union / kept, `plan_colslab`'s totals and the routed plan's
fields.  Off the card a stage measures no time.  Then `headline` on
synthetic times, and `main`: its stage order, its JSON line, no retry and
no headline from another stage when a stage raises, and a non-zero exit
without a card."""

import json

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import bench as jbench
import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.models.purification import profile_purify
from hierarchical_block_sparse_lib_tpu.ops.kpack import plan_kpack
from hierarchical_block_sparse_lib_tpu.ops.slab import plan_colslab
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm, plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu.parallel import dist as jdist, route as jroute
from hierarchical_block_sparse_lib_tpu.utils import generators as jgen
from hierarchical_block_sparse_lib_tpu_torch import bench

from torch_port_helpers import torch_threads

DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def spgemm_counters(a):
    """The JAX package's host counters of A @ A, as a bench_spgemm record
    holds them."""
    pc, oc, mbr, mcr = plan_spgemm_ex(a, a)
    g = jx.plan_groups(a, a)
    return dict(blocks=int(a.nnz), pairs=pc, out=oc, row_caps=[mbr, mcr],
                groups=None if g is None else list(g.caps))


def assert_counters(rec, want):
    assert {k: rec[k] for k in want} == want
    for key in ("unplanned", "planned"):
        assert rec["times"][key] is None  # no device time off the card
    assert rec["time_ms"] is None and rec["eff_gflops"] is None


@pytest.mark.parametrize("stage", ["b2_tile128", "b2_default"])
def test_b2_tile128_counters_match_jax(stage):
    n, dens = 1024, 0.1
    rec = (bench.b2_tile128("highest", DEV, n=n, density=dens) if stage == "b2_tile128"
           else bench.b2_default(DEV, n=n, density=dens))
    assert_counters(rec, spgemm_counters(jbench.random_block_matrix(n, 128, dens, seed=2)))
    if stage == "b2_tile128":
        assert rec["dense_n"] == n and rec["dense_ms"] is None


def test_b2_leaf32_counters_match_jax():
    n = 1024
    rec = bench.b2_leaf32("highest", DEV, n=n)
    a32 = jbench.random_block_matrix(n, 32, 0.05, seed=2)
    fine_pairs, _ = plan_spgemm(a32, a32)
    kplan = plan_kpack(a32, a32, tile=128, n_groups=32)
    ac, _ = jx.coarsen(a32, 4, cap=jx.plan_coarsen(a32, 4), track_leaves=True)
    assert rec["fine_pairs"] == fine_pairs == kplan.n_leaf_pairs
    assert rec["kpack_tiles"] == kplan.n_tiles
    assert rec["kpack_inflation"] == pytest.approx(kplan.inflation, rel=1e-12)
    assert_counters(rec["direct"], spgemm_counters(a32))
    assert_counters(rec["naive"], spgemm_counters(ac))
    assert rec["naive"]["leaf_pairs"] == fine_pairs
    assert rec["backend"]["direct_b32"] == "fine"
    assert rec["best_path"] is None and rec["best_ms"] is None


def test_b1_counters_match_jax():
    n, bw = 512, 16
    rec = bench.b1("highest", DEV, n=n, bw=bw)
    r, c, v = jgen.banded_coo(n, bw, seed=0)
    a16 = jx.from_coo(r, c, v, n, block_size=16)
    fine_pairs, _ = plan_spgemm(a16, a16)
    a, _ = jx.coarsen(a16, 8, cap=jx.plan_coarsen(a16, 8), track_leaves=True)
    assert_counters(rec, spgemm_counters(a))
    assert rec["leaf_pairs"] == fine_pairs and rec["backend"] == "groups"
    assert rec["band_ms"] is None


def test_routed_1dev_plan_matches_jax():
    n, dens = 1024, 0.1
    rec = bench.routed_1dev("highest", DEV, n=n, density=dens)
    a = jbench.random_block_matrix(n, 128, dens, seed=2)
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("p",))
    ad = jdist.distribute(a, mesh1)
    plan = jroute.plan_route(ad, ad, 1)
    want = dict(stages=list(plan.stages), total_pairs=plan.total_pairs, out_cap=plan.out_cap,
                stage_pair_caps=[int(x) for x in plan.stage_pair_caps],
                stage_out_caps=[int(x) for x in plan.stage_out_caps],
                stage_row_caps=[[int(x) for x in rc] for rc in plan.stage_row_caps],
                union_c_row_max=plan.union_c_row_max, blocks_routed=plan.blocks_routed,
                blocks_ring=plan.blocks_ring)
    assert rec["route"] == want
    assert (rec["pairs"], rec["out"]) == plan_spgemm_ex(a, a)[:2]
    assert rec["flags"] == [] and rec["routed_frozen_ms"] is None


def test_b3_profile_matches_jax():
    n, bw, steps, tau = 1024, 256, 5, 1e-6
    rec = bench.b3(DEV, n=n, bw=bw)
    # bench.py's B3 input (bench_truncation_pipeline), in the JAX package.
    a = jbench.banded_block_matrix(n, bw, 128)
    a = jx.add(a, jx.transpose(a), alpha=0.5, beta=0.5)
    a = jx.scale(a, 1.0 / float(np.sqrt(float(jx.frob_squared(a)))))
    a = jx.add(a, jx.eye(n, 128), beta=0.5, cap=a.cap + n // 128)
    prof = profile_purify(a, steps, tau=tau, target_trace=n / 2, backend="xla")
    want = dict(per_step_pairs=list(prof.per_step_pairs), per_step_out=list(prof.per_step_out),
                per_step_kept=list(prof.per_step_kept), pair_cap=prof.pair_cap,
                out_cap=prof.out_cap, cap=prof.cap, row_caps=list(prof.row_caps),
                pairs=sum(prof.per_step_pairs))
    assert {k: rec[k] for k in want} == want
    assert rec["per_step_out"] != rec["per_step_kept"]  # truncation drops blocks here
    assert rec["time_ms"] is None and rec["time_planned_ms"] is None


def test_b4_and_b4full_counters_match_jax():
    n = 1024
    rec = bench.b4("highest", DEV, n=n)
    a = jbench.random_block_matrix(n, 128, 0.5, seed=4)
    assert_counters(rec, spgemm_counters(a))
    full = bench.b4full("highest", DEV, n=n, n_slabs=2)
    plan = plan_colslab(a, a, 2)
    assert (full["blocks"], full["pairs"], full["out"]) == (int(a.nnz), plan.total_pairs,
                                                            plan.n_out)
    assert full["time_ms"] is None
    anchor = bench.b4_anchor("highest", DEV, b4full_ms=None, n=n)
    assert anchor["time_ms"] is None and anchor["b4full_vs_dense"] is None


def synthetic(key):
    """Stage records with the fields `headline` and `main` read."""
    rec = dict(backend="rows", time_ms=2.0, eff_gflops=300.0)
    if key in ("B2", "B2quick"):
        rec["dense_ms"] = 170.0
    if key == "B2leaf32":
        rec.update(best_path="fine_flat", best_ms=1.0, best_honest_gflops=22016.4)
    return rec


def test_headline_keys_and_metric():
    line = bench.headline({k: synthetic(k) for k in ("B2", "B2leaf32")})
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line == {"metric": "B2_hierarchical_spgemm_effective_gflops", "value": 22016.4,
                    "unit": "GFLOP/s", "vs_baseline": 170.0}
    quick = bench.headline({"B2quick": synthetic("B2quick")})
    assert quick == {"metric": bench.METRIC, "value": 300.0, "unit": "GFLOP/s",
                     "vs_baseline": 85.0}
    with pytest.raises(KeyError):  # no other stage stands in for the leaf-32 one
        bench.headline({"B2": synthetic("B2")})


STAGE_FUNCS = ("b2_tile128", "b2_leaf32", "b2_default", "b1", "routed_1dev", "b3", "b4",
               "b4full", "b4_anchor")
KEYS = ("B2", "B2leaf32", "B2_default", "B1", "routed_1dev", "B3", "B4", "B4full", "B4_anchor")


def fake_stages(monkeypatch, fail=None):
    """Replace every stage function by a recorder returning a synthetic
    record (`fail` raises instead); returns the list of calls."""
    calls = []
    for name, key in zip(STAGE_FUNCS, KEYS):
        def run(*args, name=name, key=key, **kw):
            calls.append(name)
            if name == fail:
                raise RuntimeError(f"{name} failed")
            return synthetic(key)
        monkeypatch.setattr(bench, name, run)
    return calls


def test_main_runs_stages_in_order_and_prints_headline(monkeypatch, capsys):
    calls = fake_stages(monkeypatch)
    assert bench.main([], device=DEV) == 0
    assert calls == list(STAGE_FUNCS)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == bench.headline(
        {k: synthetic(k) for k in ("B2", "B2leaf32")})
    staged = [json.loads(line[len("[stage] "):]) for line in err.splitlines()
              if line.startswith("[stage] ")]
    assert [s["stage"] for s in staged] == list(KEYS)
    assert all(s["backend"] for s in staged)


def test_main_quick_and_default_precision(monkeypatch, capsys):
    calls = fake_stages(monkeypatch)
    assert bench.main(["--quick"], device=DEV) == 0
    assert calls == ["b2_tile128"]
    assert json.loads(capsys.readouterr().out.strip())["value"] == 300.0
    calls.clear()
    assert bench.main(["--precision", "default"], device=DEV) == 0
    assert "b2_default" not in calls and len(calls) == len(STAGE_FUNCS) - 1


@pytest.mark.parametrize("fail", ["b2_leaf32", "b4full"])
def test_failing_stage_ends_the_run(monkeypatch, capsys, fail):
    """No retry, no swallowed exception, no headline: the stage's
    exception leaves `main` (a non-zero exit), and nothing after it runs."""
    calls = fake_stages(monkeypatch, fail=fail)
    with pytest.raises(RuntimeError, match=f"{fail} failed"):
        bench.main([], device=DEV)
    assert calls == list(STAGE_FUNCS[: STAGE_FUNCS.index(fail) + 1])
    assert capsys.readouterr().out == ""


def test_main_without_a_card_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    assert capsys.readouterr().out == ""
