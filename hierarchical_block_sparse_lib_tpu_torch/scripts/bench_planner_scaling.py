"""The route planners' host time against the shard count, on the machine
of one CUDA card: the counterpart of ``scripts/bench_planner_scaling.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.bench_planner_scaling [--max-p P]

On the B5 structure at ``b5_mix(512, 8)`` (planning depends only on the
ids and the shard count, not on the block bytes): `plan_route` and
`freeze_route_plan` for P = 2 ... 64 logical shards of one card (the
port's mesh holds them all there), with the growth exponent t ~ P^k
fitted over the upper half of the P measured; then `plan_route_2level` at
2x4, 4x4, 4x8 and 8x8.  The planners are host code (numpy and the C++
planner): CUDA events around a call read its host time, the card being
idle, and freezing's uploads are its device time.  `--max-p` stops the
sweeps at P shards.  Checks: the routed blocks and kept stages of each
flat plan, and each two-level plan's inter-host and intra-host blocks,
as the JAX package plans them (at the configured structure).

`main(device="cpu", nb=128, max_p=8)` plans at a small size on the CPU,
where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route, route2
from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import b5_mix
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import log

P_FLAT = (2, 4, 8, 16, 32, 64)
P_2LEVEL = ((2, 4), (4, 4), (4, 8), (8, 8))
# As the JAX package plans b5_mix(512, 8) on 64 virtual CPU devices:
# P -> (kept stages, blocks routed); "HxC" -> (inter-host blocks, the flat
# plan's inter-host blocks, intra-host blocks).
EXPECTED = {
    (512, 8): dict(
        flat={2: (2, 825), 4: (4, 1395), 8: (8, 1809), 16: (16, 2051), 32: (32, 2271),
              64: (64, 2541)},
        two={"2x4": (825, 1018, 8637), "4x4": (1395, 1578, 10347), "4x8": (1395, 1600, 24143),
             "8x8": (1809, 1918, 27041)}),
}


def growth(ps, ts):
    """k of t ~ P^k fitted over the upper half of the points, or None."""
    half = len(ps) // 2
    if len(ps) - half < 2 or any(t is None or t <= 0 for t in ts[half:]):
        return None
    return float(np.polyfit(np.log(ps[half:]), np.log(ts[half:]), 1)[0])


def main(argv=None, device=None, nb: int = 512, b: int = 8, max_p: int = 64) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-p", type=int, default=max_p)
    args = ap.parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("bench_planner_scaling: no CUDA device; nothing to run")
        return 2
    run = Run("bench_planner_scaling", dev)
    A = b5_mix(nb, b, device=dev)
    log(f"structure: {nb}x{nb} blocks, nnz={int(A.nnz)}; P up to {args.max_p}")
    ps = [p for p in P_FLAT if p <= args.max_p]
    hcs = [hc for hc in P_2LEVEL if hc[0] * hc[1] <= args.max_p]
    shards = {P: dist.distribute(A, dist.make_mesh(P, device=dev))
              for P in sorted(set(ps) | {h * c for h, c in hcs})}
    plans = {P: route.plan_route(shards[P], shards[P], P) for P in ps}
    flat = {P: (len(plans[P].stages), plans[P].blocks_routed) for P in ps}
    two = {}
    for h, c in hcs:
        p2 = route2.plan_route_2level(shards[h * c], shards[h * c], h, c)
        two[f"{h}x{c}"] = (p2.dcn_blocks, p2.dcn_blocks_flat, p2.ici_blocks)
    for P in ps:
        log(f"P={P:3d}: stages={flat[P][0]}  routed={flat[P][1]}  ring={plans[P].blocks_ring}")
    for k, (dcn, dcn_flat, ici) in two.items():
        log(f"{k}: dcn={dcn} (flat {dcn_flat}) ici={ici}")
    run.counters.update(nnz=int(A.nnz), flat={str(k): list(v) for k, v in flat.items()},
                        two={k: list(v) for k, v in two.items()})
    want = EXPECTED.get((nb, b))
    if want is not None:
        wf = {P: v for P, v in want["flat"].items() if P in flat}
        wt = {k: v for k, v in want["two"].items() if k in two}
        run.check("flat plans equal to the JAX package's", flat == wf, f"{flat} vs {wf}")
        run.check("two-level plans equal to the JAX package's", two == wt, f"{two} vs {wt}")

    # Host calls: the CUDA events around one read its host time (the
    # stream is idle); 3 a turn, one profiled call.
    calls = {}
    for P in ps:
        d = shards[P]
        calls[f"plan_route P={P}"] = lambda d=d, P=P: route.plan_route(d, d, P)
        calls[f"freeze P={P}"] = lambda d=d, P=P: route.freeze_route_plan(d, d, plans[P])
    for h, c in hcs:
        d = shards[h * c]
        calls[f"plan_route_2level {h}x{c}"] = lambda d=d, h=h, c=c: route2.plan_route_2level(
            d, d, h, c)
    run.measure(calls, reps=1, warmup=0, timing_reps=3)
    fits = {}
    for name in ("plan_route", "freeze"):
        fits[name] = growth(ps, [run.parts[f"{name} P={P}"]["ms"] for P in ps])
        if fits[name] is not None:
            log(f"{name}: growth ~ P^{fits[name]:.2f} over P={ps[len(ps) // 2]}..{ps[-1]}")
    return run.finish(max_p=args.max_p, growth=fits)


if __name__ == "__main__":
    sys.exit(main())
