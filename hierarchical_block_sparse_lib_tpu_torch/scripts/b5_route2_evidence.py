"""Two-level (host x chip) routing traffic on the full B5 block grid, on
the machine of one CUDA card: the counterpart of
``scripts/b5_route2_evidence.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.b5_route2_evidence [--out PATH]

Traffic depends only on the ids and the mesh's factorisation, so the
structure is B5's full 1024^2-block grid at b = 8, ``b5_mix(1024, 8)``
(byte figures at b = 128).  For 2x4, 4x2, 4x4 and 8x8 logical shards of
one card: `plan_route_2level` (inter-host blocks, the flat plan's
inter-host blocks, intra-host blocks) beside the flat router's routed
blocks and the ring's, which must equal the table of ``docs/B5_ROUTE.md``
(at the configured structure).  Then a numeric anchor: `dist_spgemm_2level`
at 4x2 against the float64 product of the dense 8192^2 input, on the
card, within 1e-5 relative to max|C|, its flags clean.  The planners' and
the anchor's times are measured (`scripts/ablation.py`).

The table is printed; the JAX script appended it to docs/B5_ROUTE.md,
and this one writes a file only where ``--out PATH`` names one.

`main(device="cpu", nb=128)` plans and runs the anchor at a small size on
the CPU, where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.bench import rel_err
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route, route2
from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import b5_mix
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import log

B_PROD = 128
MESHES = ((2, 4), (4, 2), (4, 4), (8, 8))
ANCHOR = (4, 2)
TOL = 1e-5
# docs/B5_ROUTE.md's table, as the JAX package planned b5_mix(1024, 8):
# "HxC" -> (DCN, flat inter-host, ICI, flat-routed, ring) blocks.
EXPECTED = {
    (1024, 8): {"2x4": (3340, 4627, 25482, 8176, 36078),
                "4x2": (6266, 7054, 11420, 8176, 36078),
                "4x4": (6266, 7555, 34260, 9362, 77310),
                "8x8": (8176, 9105, 93310, 10737, 324702)},
}


def mb(blocks: int) -> int:
    return round(blocks * B_PROD * B_PROD * 4 / 1e6)


def table(rows: dict, err) -> str:
    """The JAX script's markdown table and anchor line."""
    lines = ["| H x C | P | DCN blocks (MB) | flat inter-host | ICI blocks | flat-routed | ring |",
             "|---|---|---|---|---|---|---|"]
    for key, (dcn, dcn_flat, ici, flat, ring) in rows.items():
        h, c = map(int, key.split("x"))
        lines.append(f"| {key} | {h * c} | {dcn:,} ({mb(dcn)}) | {dcn_flat:,} | {ici:,} |"
                     f" {flat:,} | {ring:,} |")
    lines += ["", f"Numeric anchor: `dist_spgemm_2level` at {ANCHOR[0]}x{ANCHOR[1]} matches the "
              f"dense oracle to max rel {err:.2e}; overflow/self-checks clean."]
    return "\n".join(lines) + "\n"


def main(argv=None, device=None, nb: int = 1024, b: int = 8) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the table to this file")
    args = ap.parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("b5_route2_evidence: no CUDA device; nothing to run")
        return 2
    run = Run("b5_route2_evidence", dev)
    A = b5_mix(nb, b, device=dev)
    log(f"structure: {A.nb_rows}x{A.nb_cols} blocks, nnz={int(A.nnz)}")
    shards, plans2, calls, rows = {}, {}, {}, {}
    for h, c in MESHES:
        P = h * c
        if P not in shards:
            shards[P] = dist.distribute(A, dist.make_mesh(P, device=dev))
        d = shards[P]
        p2 = route2.plan_route_2level(d, d, h, c)
        pf = route.plan_route(d, d, P)
        key = f"{h}x{c}"
        plans2[key] = p2
        rows[key] = (p2.dcn_blocks, p2.dcn_blocks_flat, p2.ici_blocks, pf.blocks_routed,
                     pf.blocks_ring)
        log(f"H={h} C={c} (P={P}): DCN {p2.dcn_blocks} (flat inter-host {p2.dcn_blocks_flat}), "
            f"ICI {p2.ici_blocks}, flat-routed {pf.blocks_routed}, ring {pf.blocks_ring}")
        calls[f"plan_route_2level {key}"] = lambda d=d, h=h, c=c: route2.plan_route_2level(
            d, d, h, c)
        calls[f"plan_route P={P} ({key})"] = lambda d=d, P=P: route.plan_route(d, d, P)
    run.counters.update(nnz=int(A.nnz), rows={k: list(v) for k, v in rows.items()})
    run.check("DCN <= flat inter-host at every factorisation",
              all(r[0] <= r[1] for r in rows.values()))
    want = EXPECTED.get((nb, b))
    if want is not None:
        run.check("table equal to docs/B5_ROUTE.md", rows == want, f"{rows} vs {want}")

    h, c = ANCHOR
    key = f"{h}x{c}"
    mesh_hc = route2.make_mesh_2level(h, c, device=dev)
    Ad = shards[h * c]

    def anchor():
        return route2.dist_spgemm_2level(Ad, Ad, mesh_hc, plans2[key], backend="xla")

    C2, st = anchor()
    dA = hbsm.to_dense(A).double()
    err = rel_err(hbsm.to_dense(dist.undistribute(C2)), dA @ dA)
    del dA, C2
    run.counters["anchor_rel_err"] = err
    run.check(f"anchor {key} within {TOL} of f64, overflow clean",
              not bool(st["overflow"]) and not bool(st["plan_mismatch"]) and err < TOL,
              f"{err:.2e}")
    calls[f"dist_spgemm_2level {key}"] = anchor
    run.measure(calls, reps=1, warmup=1, timing_reps=3)
    text = table(rows, err)
    log("\n" + text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        log(f"wrote {args.out}")
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
