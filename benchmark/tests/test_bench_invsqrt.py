"""The ``invsqrt`` op at a cut size on the CPU: the cell
`b3_invsqrt.planned` runs correct, the control and each planted fault
come out not correct, its modules import what they may, and
`ns_host_ms` reads a synthetic trace."""

import time

import pytest
import torch

from bench_small import SEED, spec
from benchmark import faults, harness
from benchmark.trace import TraceSummary
from test_bench_imports import JAX_NAMES, PORT, loaded_top_names, modules

WORKLOAD = "b3_invsqrt.planned"
# 32 molecules (n = 416, the least that fills leaf blocks of 32); 11 steps,
# one past the float64 reference's best step at this size.
SMALL = dict(molecules=32)
ASSUMED = dict(n_steps=11)


def small_cell() -> harness.Cell:
    cell = harness.find_cell(spec(), WORKLOAD)
    cell.cfg.update(SMALL)
    cell.cfg["assumed"].update(ASSUMED)
    return cell


def run_small(trace: bool = False, mode: str = "f64") -> dict:
    torch.set_num_threads(1)
    return harness.run_cell(small_cell(), SEED, 0.2, trace, "cpu", time.perf_counter(), mode=mode)


def test_invsqrt_cell_runs_correct_on_cpu():
    r = run_small()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"z_err", "orphan_over_tau", "orth_err", "pairs_rel_diff",
                                "replans", "failed_calls"}
    assert {"setup_s", "leaf_gflops"} <= set(r["metrics"])
    r = run_small(trace=True)
    assert r["correct"] and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_invsqrt_control_is_not_correct():
    r = run_small(mode="tf32")
    assert r["correct"] is False
    for k in ("z_err", "orth_err"):
        assert r["checks"][k]["value"] > r["checks"][k]["limit"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_invsqrt_fault_is_not_correct(fault):
    with faults.planted(fault):
        r = run_small()
    assert r["correct"] is False
    assert [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]


def test_invsqrt_modules_import_no_jax():
    names = modules()
    mine = {"benchmark.reference.invsqrt", "benchmark.systems.invsqrt",
            "benchmark.metrics.ns_host_ms"}
    assert mine <= set(names)
    assert not loaded_top_names(sorted(mine)) & JAX_NAMES
    assert PORT not in loaded_top_names(["benchmark.reference.invsqrt"])


def test_ns_host_ms_reads_the_engines_host_gaps():
    reader = harness.load_reader("ns_host_ms")
    run = harness.Run()
    assert reader.read(run) is None  # untraced
    run.trace = TraceSummary(calls=4, window_s=1.0, device_ops=100, idle_seconds={
        "bench.call/hbsm.inv_sqrt": 0.006, "bench.call/hbsm.engine_check": 0.002,
        "bench.call/cudaLaunchKernel": 0.5, "outside/python": 0.1})
    assert reader.read(run) == pytest.approx(2.0)
    run.trace.idle_seconds = {"bench.call/hbsm.purify": 0.1}
    assert reader.read(run) is None  # no engine on the path
