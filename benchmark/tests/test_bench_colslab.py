"""The ``colslab`` op at a cut size on the CPU: the cell `b4full.colslab`
runs correct, the control and each fault planted at the row-panel kernel
come out not correct, its modules import what they may, and
`rows_kernel_roofline_pct` reads a synthetic trace and nothing without one."""

import time

import pytest
import torch

from bench_small import SEED, spec
from benchmark import faults, harness
from benchmark.tools.readings_rows import planted
from benchmark.trace import TraceSummary
from test_bench_imports import JAX_NAMES, PORT, loaded_top_names, modules

WORKLOAD = "b4full.colslab"
# 8 block rows and columns of 128 at the configured density and slabs.
SMALL = dict(n=1024)


def small_cell() -> harness.Cell:
    cell = harness.find_cell(spec(), WORKLOAD)
    cell.cfg.update(SMALL)
    return cell


def run_small(trace: bool = False, mode: str = "f64") -> dict:
    torch.set_num_threads(1)
    return harness.run_cell(small_cell(), SEED, 0.2, trace, "cpu", time.perf_counter(), mode=mode)


def test_colslab_cell_runs_correct_on_cpu():
    r = run_small()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"d_err", "ids_diff", "pairs_diff", "out_diff", "failed_calls"}
    assert {"setup_s", "leaf_gflops"} <= set(r["metrics"])
    r = run_small(trace=True)
    assert r["correct"] and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["metrics"] == {}  # no device timeline on the CPU


def test_colslab_control_is_not_correct():
    r = run_small(mode="tf32")
    assert r["correct"] is False
    assert r["checks"]["d_err"]["value"] > r["checks"]["d_err"]["limit"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_colslab_rows_fault_is_not_correct(fault):
    with planted(fault):
        r = run_small()
    assert r["correct"] is False
    assert [k for k, c in r["checks"].items() if not c["value"] <= c["limit"]]


def test_colslab_modules_import_no_jax():
    names = modules()
    mine = {"benchmark.reference.colslab", "benchmark.systems.colslab",
            "benchmark.metrics.rows_kernel_roofline_pct"}
    assert mine <= set(names)
    assert not loaded_top_names(sorted(mine)) & JAX_NAMES
    assert PORT not in loaded_top_names(["benchmark.reference.colslab"])


def test_rows_kernel_roofline_pct_reads_the_rows_kernel():
    reader = harness.load_reader("rows_kernel_roofline_pct")
    run = harness.Run(least_s=0.4)
    assert reader.read(run) is None  # untraced
    run.trace = TraceSummary(calls=4, window_s=1.0, device_ops=100, op_seconds={
        "void rows_spgemm_kernel<128, 2>(int const*)": 0.8, "index_copy": 0.1})
    assert reader.read(run) == pytest.approx(50.0)
    run.trace.op_seconds = {"fine_spgemm_kernel<32, 3, 128>": 0.8}
    assert reader.read(run) is None  # the row-panel kernel did not run

