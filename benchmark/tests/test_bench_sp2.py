"""The ``sp2`` op at a cut size on the CPU: the cell `b3_sp2.planned`
runs correct, the control and each planted fault come out not correct,
its modules import what they may, and `fine_kernel_roofline_pct` reads a
synthetic trace."""

import time

import pytest
import torch

from bench_small import SEED, spec
from benchmark import faults, harness
from benchmark.trace import TraceSummary
from test_bench_imports import JAX_NAMES, PORT, loaded_top_names, modules

WORKLOAD = "b3_sp2.planned"
# 64 molecules (n = 832); 32 steps, the configuration's rule at this size.
SMALL = dict(molecules=64)
ASSUMED = dict(n_occ=320, n_steps=32)


def small_cell() -> harness.Cell:
    cell = harness.find_cell(spec(), WORKLOAD)
    cell.cfg.update(SMALL)
    cell.cfg["assumed"].update(ASSUMED)
    return cell


def run_small(trace: bool = False, mode: str = "f64") -> dict:
    torch.set_num_threads(1)
    return harness.run_cell(small_cell(), SEED, 0.2, trace, "cpu", time.perf_counter(), mode=mode)


def test_sp2_cell_runs_correct_on_cpu():
    r = run_small()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"d_err", "orphan_over_tau", "trace_err", "pairs_rel_diff",
                                "replans", "failed_calls"}
    assert {"setup_s", "leaf_gflops"} <= set(r["metrics"])
    r = run_small(trace=True)
    assert r["correct"] and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_sp2_control_is_not_correct():
    r = run_small(mode="tf32")
    assert r["correct"] is False
    assert r["checks"]["d_err"]["value"] > r["checks"]["d_err"]["limit"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_sp2_fault_is_not_correct(fault):
    with faults.planted(fault):
        r = run_small()
    assert r["correct"] is False
    assert [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]


def test_sp2_modules_import_no_jax():
    names = modules()
    mine = {"benchmark.reference.sp2", "benchmark.systems.sp2",
            "benchmark.metrics.fine_kernel_roofline_pct", "benchmark.tools.sp2_steps"}
    assert mine <= set(names)
    assert not loaded_top_names(sorted(mine)) & JAX_NAMES
    assert PORT not in loaded_top_names(["benchmark.reference.sp2"])


def test_fine_kernel_roofline_pct_reads_the_fine_kernel_alone():
    reader = harness.load_reader("fine_kernel_roofline_pct")
    run = harness.Run(least_s=0.001)
    assert reader.read(run) is None  # untraced
    run.trace = TraceSummary(calls=2, window_s=1.0, op_seconds={
        "void (anonymous namespace)::fine_spgemm_kernel<32, 0>(int const*)": 0.003,
        "void (anonymous namespace)::union_add_blocks(float const*)": 0.5,
        "void (anonymous namespace)::fine_spgemm_kernel<32, 2>(int const*)": 0.001,
    })
    assert reader.read(run) == pytest.approx(25.0)
    run.trace.op_seconds = {"elementwise_kernel": 0.1}
    assert reader.read(run) is None  # no fine kernel on the path
