"""The readings a cell's limits are set from, in one process: the
program's compared numbers over many seeds, the control's (the
reference at TF32 in the program's place) and each planted fault's.

    python3 benchmark/tools/readings.py --workload b2_chain.planned \
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7 --seconds 1

Each reading is a short window of the cell's own calls at its own size,
then the run's check.  Prints one JSON line per reading and, per number,
the largest program reading and the smallest control and fault
readings.  Not run by the benchmark itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join("chiprun_out", "readings.jsonl"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import faults, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(spec, args.workload)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    jobs = [("program", s, None) for s in seeds(args.seeds)]
    jobs += [("control", s, None) for s in seeds(args.control_seeds)]
    jobs += [(f"fault:{f}", s, f) for s in seeds(args.fault_seeds) for f in faults.FAULTS]
    worst, least = {}, {}
    os.makedirs(os.path.dirname(os.path.join(ROOT, args.out)), exist_ok=True)
    with open(os.path.join(ROOT, args.out), "a") as log:
        for kind, seed, fault in jobs:
            ctx = faults.planted(fault) if fault else _null()
            with ctx:
                r = harness.run_cell(cell, seed, args.seconds, False, args.device,
                                     time.perf_counter(),
                                     mode="tf32" if kind == "control" else "f64")
            nums = {k: v["value"] for k, v in r["checks"].items()}
            line = dict(workload=args.workload, kind=kind, seed=seed, correct=r["correct"],
                        attempted=r["attempted"], numbers=nums)
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
            for k, v in nums.items():
                if kind == "program":
                    worst[k] = max(worst.get(k, v), v)
                else:
                    least.setdefault(kind, {})
                    least[kind][k] = min(least[kind].get(k, v), v)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": worst, "others_min": least}))
    return 0


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


if __name__ == "__main__":
    sys.exit(main())
