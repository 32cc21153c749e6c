"""The harness finds cells, traffic mixes and metrics by name, a file
added in a copy becomes a cell without an edit, and a run at cut sizes on
the CPU ends with the contract's fields, its numbers within their
limits."""

import json
import os
import shutil
import subprocess
import sys
import weakref

import pytest
import torch

from bench_small import SEED, WORKLOADS, run_small, spec
from benchmark import harness


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct_on_cpu(workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    names = {m["name"] for m in harness.find_cell(spec(), workload).end_to_end}
    assert {"setup_s", "peak_mem_gib"} < names
    # No device here: the memory peak has nothing to read.
    assert set(r["metrics"]) == names - {"peak_mem_gib"}
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_run_reports_breakdown(workload):
    r = run_small(workload, trace=True)
    assert r["correct"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
    # No device here: no per-layer metric has anything to read.
    assert r["metrics"] == {}


def test_every_named_file_exists():
    s = spec()
    for c in s["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "systems", cfg["op"] + ".py"))
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "reference", cfg["op"] + ".py"))
    for w in s["workloads"]:
        assert harness.find_cell(s, w["name"]).traffic["pool"] >= 1
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness.load_reader(m["name"]).read)


def test_added_files_make_a_cell_without_an_edit(tmp_path):
    """A traffic mix, a metric and a cell added as files and entries in a
    copy run through the harness; no existing file changes."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    s["workloads"].append({"name": "b2_chain.planned2", "config": "b2_random16k_leaf32",
                           "traffic": "planned_pool2", "chips": 1, "why": "test"})
    s["end_to_end"].append({"name": "leaf_gflops.pool2", "unit": "GFLOP/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock",
                            "workloads": ["b2_chain.planned2"]})
    s["per_layer"].append({"name": "calls.count", "unit": "calls", "better": "higher",
                           "source": "program_counter", "layer": "entry",
                           "moves": "leaf_gflops.pool2", "workloads": ["b2_chain.planned2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    traffic = json.loads((root / "benchmark/traffic/planned.json").read_text())
    traffic["pool"] = 2
    (root / "benchmark/traffic/planned_pool2.json").write_text(json.dumps(traffic))
    (root / "benchmark/metrics/calls.count.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    code = (
        "import json, sys, time, torch\n"
        "from benchmark import harness\n"
        "s = harness.load_json('BENCHMARK.json')\n"
        "c = harness.find_cell(s, 'b2_chain.planned2')\n"
        "c.cfg['n'] = 1024\n"
        "torch.set_num_threads(1)\n"
        "r0 = harness.run_cell(c, %d, 0.2, False, 'cpu', time.perf_counter())\n"
        "r1 = harness.run_cell(c, %d, 0.2, True, 'cpu', time.perf_counter())\n"
        "print(json.dumps([r0, r1]))\n" % (SEED, SEED)
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), harness.ROOT]))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r0, r1 = json.loads(p.stdout.strip().splitlines()[-1])
    assert r0["correct"] and r1["correct"], (r0["checks"], r1["checks"])
    # The new cell's rate is read by leaf_gflops.py, found by the name's first part.
    assert r0["metrics"]["leaf_gflops.pool2"]["value"] > 0
    assert r1["metrics"]["calls.count"]["value"] == r1["attempted"]


def test_runner_refuses_without_a_card():
    """No CUDA card: exit non-zero and no result line, nothing measured."""
    p = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"), "--workload",
         "b2_chain.planned", "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


class _Answer:
    pass


class _Session:
    """Counts the answers it has handed out that are still alive."""

    def __init__(self):
        self.alive = weakref.WeakSet()
        self.most = 0

    def call(self, i):
        self.most = max(self.most, len(self.alive))
        out = _Answer()
        out.flag = torch.tensor(i == 3)
        self.alive.add(out)
        return out

    @staticmethod
    def flags(out):
        return [out.flag]

    @staticmethod
    def export(out):
        return out.flag.item()


def test_the_window_keeps_no_answer():
    """Each call's answer is released before the next call, and its
    flags are counted; the answers compared come from calls made after
    the window, every pool member's."""
    s = _Session()
    call_s, flagged, done, _ = harness._loop(s, 0.05, torch.device("cpu"), spans=False)
    assert s.most == 0 and len(s.alive) == 0
    assert len(done) == len(call_s) >= 4 and flagged == 1
    answers, failed = harness._check_calls(s, 3, 2, 100, torch.device("cpu"))
    assert sorted(answers) == [0, 1, 2] and all(len(v) == 2 for v in answers.values())
    assert failed == 0
