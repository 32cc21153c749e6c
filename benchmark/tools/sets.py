"""Run cells of the benchmark several times, each run its own process, and
summarise each metric's median and spread.

    python3 benchmark/tools/sets.py --workload b2_chain.oneoff --seeds 11,12,13 \
        --seconds 10 [--trace 0|1] [--sets 2] [--out chiprun_out/sets.jsonl]

`--workload` may name several cells, comma-separated; all sets of one
cell run before the next cell.  Every set runs the same seeds in the
same order.  The spread of a metric is the distance between its first
and third quartiles (``statistics.quantiles(values, n=4)``) over its
median.  Each run's result line, exit code and the end of its standard
error go to `--out` as JSON lines.  Not run by the benchmark itself.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def one_run(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, os.path.join("benchmark", "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return dict(workload=workload, seed=seed, seconds=seconds, trace=trace, rc=rc,
                wall_s=time.perf_counter() - t0, result=result, stderr_tail=err[-3000:])


def spread(values: list) -> tuple:
    """(median, (q3 - q1) / median) of `values`."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out", default=os.path.join("chiprun_out", "sets.jsonl"))
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    os.makedirs(os.path.dirname(os.path.join(ROOT, args.out)), exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    bad = 0
    with open(os.path.join(ROOT, args.out), "a") as log:
        for wl in args.workload.split(","):
            per_set = []
            for s in range(args.sets):
                runs = []
                for seed in seeds:
                    r = one_run(wl, seed, args.seconds, args.trace, args.timeout)
                    r["set"], r["card"] = s, card
                    log.write(json.dumps(r) + "\n")
                    log.flush()
                    res = r["result"]
                    ok = r["rc"] == 0 and res is not None and res.get("correct")
                    bad += not ok
                    brief = {k: v["value"] for k, v in (res or {}).get("metrics", {}).items()}
                    checks = {k: v["value"] for k, v in (res or {}).get("checks", {}).items()}
                    print(f"{wl} set {s} seed {seed} rc {r['rc']} wall {r['wall_s']:.1f}s "
                          f"correct {None if res is None else res['correct']} "
                          f"attempted {None if res is None else res['attempted']} "
                          f"metrics {json.dumps(brief)} checks {json.dumps(checks)}", flush=True)
                    if not ok:
                        print(r["stderr_tail"][-1500:], flush=True)
                    runs.append(res)
                per_set.append(runs)
            names = sorted({k for runs in per_set for r in runs if r for k in r["metrics"]})
            for name in names:
                cells = []
                for s, runs in enumerate(per_set):
                    vals = [r["metrics"][name]["value"] for r in runs if r and name in r["metrics"]]
                    if vals:
                        med, sp = spread(vals)
                        cells.append(f"set {s}: median {med!r} spread {sp:.4%} (n={len(vals)})")
                print(f"{wl} {name}: " + "; ".join(cells), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
