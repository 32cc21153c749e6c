"""One traced run of a cell, as ``benchmark/run.py --trace 1`` makes it,
with the program's ``hbsm.`` spans reduced per layer (``spans.py``).

    python3 benchmark/tools/span_table.py --workload b2_chain.oneoff --seed 7 [--seconds 3]

The harness keeps a traced window's events to itself, so this tool wraps
``trace.summarize`` to reduce the same event list once more, and keeps
the run's ``Run`` for its least time.  Standard error ends with the span
table (calls, host ms, self host ms, device ms and syncs per call, the
unattributed share); the last line of standard output is one JSON
object: the run's result fields, each span's totals and the layers'
numbers per call.  Not run by the benchmark itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def traced_run(cell, seed: int, seconds: float, device, t_start: float):
    """``harness.run_cell`` traced, and the same window's span summary:
    (result, spans.SpanSummary, the run's ``Run``)."""
    from benchmark import harness, spans, trace

    captured, runs = {}, []
    summarize, run_class = trace.summarize, harness.Run

    def summarize_both(events, calls, window_s, window_span):
        captured["spans"] = spans.summarize(events, calls, window_span)
        return summarize(events, calls, window_s, window_span)

    class KeptRun(run_class):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

    trace.summarize, harness.Run = summarize_both, KeptRun
    try:
        result = harness.run_cell(cell, seed, seconds, True, device, t_start)
    finally:
        trace.summarize, harness.Run = summarize, run_class
    return result, captured["spans"], runs[0]


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        harness.log("span_table: no CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cell = harness.find_cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    result, s, run = traced_run(cell, args.seed, args.seconds, "cuda", t_start)
    harness.log(s.table())
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(),
        "correct": result["correct"], "attempted": result["attempted"],
        "metrics": result["metrics"], "device": result["device"],
        "breakdown": result["breakdown"], "checks": result["checks"],
        "spans": {k: dataclasses.asdict(v) for k, v in s.spans.items()},
        "values": s.values(run.least_s),
    }), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
