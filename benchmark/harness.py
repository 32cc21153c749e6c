"""One run of one cell: inputs from the seed, the system's set-up and
warm-up, a closed loop of one caller for the window, then the check
against the plain reference of the answers of calls made right after
the window, the metrics and the result's line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by name:

- ``BENCHMARK.json`` (repository root): the cells, and the metrics each
  reports;
- a configuration's ``file``: its sizes, its ``op`` and the limits of the
  numbers its check compares;
- ``traffic/<traffic>.json``: where the structure is found (``plan``),
  the pool of distinct inputs, warm-up rounds, answers checked per pool
  member and the traced window's length;
- ``systems/<op>.py``: the program's calls (``Session``);
- ``reference/<op>.py``: the inputs, the plain reference, the work a
  call does, and the comparison;
- ``metrics/<metric>.py``: ``read(run)``, the metric's value, or None
  where the run has nothing to read.  A metric named ``<base>.<group>``
  (the same quantity over another group of cells, with a bound of its
  own) is read by ``metrics/<base>.py`` unless it has a file of its own.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

import torch

from benchmark import counts

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
WINDOW_SPAN = "bench.window"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """``metrics/<name>.py`` as a module, else that of the name up to its
    first dot."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    workload: dict
    cfg: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def find_cell(spec: dict, name: str) -> Cell:
    """The cell `name` of `spec` (BENCHMARK.json), its configuration,
    traffic and the metrics it reports."""
    wl = {w["name"]: w for w in spec["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    cfg = load_json(os.path.join(ROOT, entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{wl['traffic']}.json"))

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(wl, cfg, traffic, mine(spec["end_to_end"]), mine(spec["per_layer"]))


@dataclass
class Run:
    """What the metric readers read."""

    calls: int = 0
    failed: int = 0
    call_s: list = field(default_factory=list)
    window_s: float = 0.0
    flops: float = 0.0  # products' FLOPs of the completed calls
    least_s: float = 0.0  # least device time of the completed calls
    peak_bytes: int = 0
    setup_s: float = 0.0
    trace: object = None  # trace.TraceSummary of a traced run


def peaks_for(kind: str, precision: str):
    """(FLOP/s of the configured precision's fastest faithful route, HBM
    bytes/s) of the card named `kind`, or None for a card the table lacks."""
    for key, p in load_json(os.path.join(BENCH_DIR, "peaks.json"))["cards"].items():
        if key in kind:
            return p["flops_per_s"][precision], p["bytes_per_s"]
    return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loop(session, seconds, device, spans):
    """The closed loop of one caller: call, wait, next call, until the
    window's time is up.  No answer is kept: each call's failure flags
    are folded into one counter on the device, so the window's memory is
    the program's alone.  Returns (per-call seconds, calls whose flags
    report a failure, indices of the calls that returned, window
    seconds)."""
    span = torch.profiler.record_function if spans else (lambda _: contextlib.nullcontext())
    call_s, done = [], []
    flagged = torch.zeros((), dtype=torch.int32, device=device)
    i = 0
    t_w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            with span("bench.call"):
                out = session.call(i)
            with span("bench.sync"):
                _sync(device)
        except Exception as exc:  # a failed call counts and the window goes on
            log(f"call {i} raised {type(exc).__name__}: {exc}")
            out = None
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        if out is not None:
            flagged += _failed(session, out)
            done.append(i)
        del out
        i += 1
        if t1 - t_w0 >= seconds:
            return call_s, int(flagged), done, t1 - t_w0


def _failed(session, out) -> torch.Tensor:
    """0-dim bool: the call's flags report an overflow or a plan mismatch."""
    return torch.cat([f.reshape(-1) for f in session.flags(out)]).any()


def _check_calls(session, pool, k, start, device):
    """The answers compared: `k` calls per pool member, made right after
    the window by the same session and loop, from call index `start`.
    Returns ({member: [exported answers]}, calls that failed)."""
    answers, failed = {}, 0
    for i in range(start, start + k * pool):
        try:
            out = session.call(i)
            _sync(device)
        except Exception as exc:
            log(f"checked call {i} raised {type(exc).__name__}: {exc}")
            failed += 1
            continue
        failed += bool(_failed(session, out))
        answers.setdefault(i % pool, []).append(session.export(out))
        del out
    return answers, failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, mode: str = "f64") -> dict:
    """One run; returns the result's fields and the numbers checked.
    `mode` other than "f64" puts the reference at that precision in the
    program's place (the control): the program is still timed, and its
    checked answers are replaced by the control's before the check."""
    device = torch.device(device)
    cfg, traffic = cell.cfg, cell.traffic
    system = importlib.import_module(f"benchmark.systems.{cfg['op']}")
    ref_mod = importlib.import_module(f"benchmark.reference.{cfg['op']}")
    pool = traffic["pool"]

    with torch.profiler.record_function("bench.setup"):
        members = ref_mod.make_inputs(cfg, pool, seed, device)
        session = system.Session(cfg, traffic, members)
        for i in range(traffic["warmup_rounds"] * pool):
            session.call(i)
            _sync(device)
    run = Run()
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_start

    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        seconds = min(seconds, traffic["trace_seconds"])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                if device.type == "cuda":
                    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    ev0.record()
                res = _loop(session, seconds, device, spans=True)
                if device.type == "cuda":
                    ev1.record()
                    ev1.synchronize()
        call_s, flagged, done, window_s = res
        if device.type == "cuda":
            window_s = ev0.elapsed_time(ev1) * 1e-3
    else:
        call_s, flagged, done, window_s = _loop(session, seconds, device, spans=False)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
        memory_peak = max(setup_peak, run.peak_bytes)
    else:
        memory_peak = 0
    if trace:
        from benchmark import trace as trace_mod

        run.trace = trace_mod.summarize(prof.profiler.kineto_results.events(),
                                        len(call_s), window_s, WINDOW_SPAN)
        del prof
    run.calls, run.call_s, run.window_s = len(call_s), call_s, window_s
    if len(call_s) >= 2:
        half, med = len(call_s) // 2, statistics.median
        log(f"window: {len(call_s)} calls in {window_s:.3f} s; call ms min "
            f"{min(call_s) * 1e3:.3f} median {med(call_s) * 1e3:.3f} max {max(call_s) * 1e3:.3f}; "
            f"median of the first half {med(call_s[:half]) * 1e3:.3f}, of the second "
            f"{med(call_s[half:]) * 1e3:.3f}")
    run.failed = run.calls - len(done) + flagged

    exports, check_failed = _check_calls(session, pool, traffic["samples"], run.calls, device)
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = {}
    work = {}
    for m, member in enumerate(members):
        ref = ref_mod.reference(cfg, member, "f64")
        work[m] = ref_mod.work(cfg, member, ref)
        answers = exports.get(m, [])
        if mode != "f64" and answers:
            answers = [ref_mod.answer(ref_mod.reference(cfg, member, mode))]
        for got in answers:
            for k, v in ref_mod.compare(got, ref).items():
                numbers[k] = max(numbers.get(k, v), v)
        del ref, answers
    numbers["failed_calls"] = run.failed + check_failed
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    peaks = peaks_for(kind, cfg["precision"])
    for i in done:
        w = work[i % pool]
        run.flops += w["flops"]
        if peaks:
            run.least_s += counts.least_seconds(w["flops"], w["bytes"], *peaks)

    limits = cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and all(m in exports for m in range(pool)))
    metrics = {}
    for metric in cell.per_layer if trace else cell.end_to_end:
        v = load_reader(metric["name"]).read(run)
        if v is not None:
            metrics[metric["name"]] = {"value": v, "unit": metric["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
           "count": cell.workload["chips"], "memory_peak_bytes": memory_peak}
    if trace:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
    result = {"correct": correct, "attempted": run.calls, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result
