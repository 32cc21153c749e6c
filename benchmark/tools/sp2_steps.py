"""The reference's SP2 scan of a configuration on one seed, step by step:
each step's input trace, branch, pairs and kept blocks, and the
idempotency ||X^2 - X||_F / ||X||_F of its output, in float64; and the
step count the configuration's ``n_steps`` rule gives (the least count
after which the idempotency is below 1e-5, plus 2).

    python3 benchmark/tools/sp2_steps.py --config sp2_water2048_321g_leaf32 \
        --seed 2200002201 [--steps 46] [--eig]

With `--eig`, also the spectrum's ends and the HOMO-LUMO gap (a dense
eigensolve of F).  One JSON line on standard output; not run by the
benchmark itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BELOW, EXTRA = 1e-5, 2  # the configuration's rule for n_steps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=46)
    p.add_argument("--eig", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    from benchmark.reference import common, sp2

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = {c["name"]: c for c in spec["configs"]}[args.config]
    cfg = harness.load_json(os.path.join(ROOT, entry["file"]))
    t0 = time.perf_counter()
    m = sp2.make_inputs(cfg, 1, args.seed, args.device)[0]
    out = dict(config=args.config, seed=args.seed, blocks=int(m.ids.size),
               inputs_s=time.perf_counter() - t0)
    if args.eig:
        f = common.dense(m.ids, m.data, m.n // m.b, torch.float64)
        ev = torch.linalg.eigvalsh(f)
        n_occ = int(cfg["assumed"]["n_occ"])
        out.update(eig_min=float(ev[0]), eig_max=float(ev[-1]), homo=float(ev[n_occ - 1]),
                   lumo=float(ev[n_occ]), gap=float(ev[n_occ] - ev[n_occ - 1]))
        del f, ev
    t0 = time.perf_counter()
    r = sp2.reference(cfg, m, "f64", steps=args.steps, last_idempotency=True)
    out["scan_s"] = time.perf_counter() - t0
    below = [k for k, v in enumerate(r["idempotency"]) if v < BELOW]
    out.update(rho=r["rho"], nnz0=r["nnz0"], trace=r["trace"], up=r["up"], pairs=r["pairs"],
               kept=r["kept"], idempotency=r["idempotency"], final_trace=r["final_trace"],
               n_steps=below[0] + 1 + EXTRA if below else None)
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
