"""Cut sizes of the configurations, small enough for the CPU tests: the
same keys and arithmetic, fewer blocks."""

from __future__ import annotations

import os
import time

import torch

from benchmark import harness

SMALL = {"b2_random16k_leaf32": dict(n=1024)}
WORKLOADS = ("b2_chain.planned", "b2_chain.oneoff")
SEED = 2**31 + 12345


def spec(root: str = harness.ROOT) -> dict:
    return harness.load_json(os.path.join(root, "BENCHMARK.json"))


def small_cell(workload: str) -> harness.Cell:
    cell = harness.find_cell(spec(), workload)
    cell.cfg.update(SMALL[cell.workload["config"]])
    return cell


def run_small(workload: str, seed: int = SEED, trace: bool = False, mode: str = "f64",
              seconds: float = 0.2) -> dict:
    torch.set_num_threads(1)
    return harness.run_cell(small_cell(workload), seed, seconds, trace, "cpu",
                            time.perf_counter(), mode=mode)
