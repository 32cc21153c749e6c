"""Time the fine kernel alone (`kernels/pallas_gemm_fine.py::launch`) at
B2's structure scaled to each leaf and tier, and sweep its two launch
sizes at B2 itself.

For each leaf b in {16, 32, 64}: ``random_block_matrix(16384, b, 0.05,
seed=2)`` squared, alpha 0.5, through `make_fine_plan`'s tables and
`_operands`, one launch per call at "highest", "high" and "default":
CUDA-event median of 7 after 2 warm-ups, ns per leaf product per SM (132
SMs), the bound (the products at `product_route`'s peak: 3xTF32 at b = 32
"highest", FP32 at b = 16 and 64, three bf16 passes at "high", one at
"default"; or bytes at 3.35 TB/s, whichever is larger), and the
launch's k-chunk, shared memory, occupancy, registers and spills
(`launch_config`).  Then the launch sizes (`sweep_launch`): the resident
blocks per SM the shared memory is sized for (and at b = 32 "highest"
the narrow shape) against the column windows of the chunk table
(`slot_chunks`), and at b = 32 "highest" the chunk of C-row slots per
thread block.  Run on a CUDA card:

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.time_fine_kernel

`main(device="cpu", n=512)` runs each leaf and tier through the kernel's
plain version on the CPU, where no time is measured.
"""

from __future__ import annotations

import sys

import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.scripts.micro_fine_kernel import (
    fmt_ms,
    header,
    on_card,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import bound, card_time_ms, log

SMS = 132  # streaming multiprocessors of an H100 SXM
TIERS = ("highest", "high", "default")
# Launch sizes tried: resident blocks per SM, chunk sizes, and column
# windows (as a count of windows over the output columns).
SWEEP = dict(ctas_per_sm=(1, 2), chunk_slots=(64, 256), windows=(1, 2, 4, 5, 8, 16))


def leaf_case(device, n, leaf, density, seed):
    """(plan, geometry, flat operand, pairs, output blocks, row caps)."""
    A = random_block_matrix(n, leaf, density, seed=seed, device=device)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    Af = hbsm.fine_pack(A)
    plan = hbsm.make_fine_plan(Af, Af, pc, oc, (mbr, mcr))
    return plan, Af, pc, oc, mbr


def sweep_launch(plan, at, bt, oc, nbr, nbc, mbr, prec, leaf, tier) -> dict:
    """The kernel alone in blocks of 256 threads sized for 1 and 2 resident
    blocks per SM and, at b = 32 "highest", in `pf.NARROW`'s shape, at each
    column window of the chunk table; at b = 32 "highest" also each chunk
    size in `launch_shape`'s shape: {("sweep", leaf, tier, "<blocks>x<threads>"
    or "default", chunk_slots, windows): ms, None where the shared memory does
    not fit}.  A variant with the default's k-chunk must equal the default
    launch bitwise (the same serial sums per slot); one with another
    k-chunk, within 1e-5 (at "highest" FFMA a slot's two K-halves meet the
    carried sum in another order)."""
    picked = pf.launch_shape(leaf, prec, oc, nbr, nbc, bt.shape[0])
    want = pf.launch(plan.out_ids, plan.tables, at, bt, oc, nbr, nbc, mbr, prec)
    kc0 = pf.launch_config(leaf, prec, mbr, picked)["kc"]
    shapes = [(256, ctas) for ctas in SWEEP["ctas_per_sm"]] + pf.shapes(leaf, prec)[1:]
    variants = [(shape, pf.CHUNK_SLOTS, w) for shape in shapes for w in SWEEP["windows"]]
    if (leaf, tier) == (32, "highest"):
        variants += [(None, cs, 4) for cs in SWEEP["chunk_slots"]]
    res = {}
    for shape, cs, n_win in variants:
        chunks = pf.slot_chunks(plan.out_ids, plan.tables[4], nbc, cs, -(-nbc // n_win))
        tables = plan.tables[:6] + (chunks,)

        def run(tables=tables, shape=shape):
            return pf.launch(plan.out_ids, tables, at, bt, oc, nbr, nbc, mbr, prec, shape=shape)
        label = "default" if shape is None else f"{shape[1]}x{shape[0]}"
        key = ("sweep", leaf, tier, label, cs, n_win)
        try:
            cfg = pf.launch_config(leaf, prec, mbr, shape or picked)
        except RuntimeError as e:  # the ring alone outgrows the budget
            log(f"  sweep {tier}: {label} per SM: {e}")
            res[key] = None
            continue
        got = run()
        same = torch.equal(got, want)
        if not (same or cfg["kc"] != kc0 and torch.allclose(got, want, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"sweep {key} differs from the default launch")
        ms, _ = card_time_ms(run, "cuda")
        res[key] = ms
        log(f"  sweep {tier}: {cs} slots per block, {n_win} column windows, "
            f"{cfg['threads']} threads sized for {(shape or picked)[1]} per SM (k-chunk "
            f"{cfg['kc']}, {cfg['smem_bytes']} B, "
            f"{cfg['blocks_per_sm']} resident, {cfg['registers']} registers): "
            f"{fmt_ms(ms)}, {'bitwise equal' if same else 'within 1e-5'}")
    return res


def main(device="cuda", n: int = 16384, density: float = 0.05, seed: int = 2,
         leaves=(16, 32, 64), sweep: bool = True) -> dict:
    """Returns {(leaf, tier): record} and, with `sweep` on the card,
    `sweep_launch`'s entries; times are None off the card."""
    card = header(device)
    res = {}
    for leaf in leaves:
        plan, Af, pc, oc, mbr = leaf_case(device, n, leaf, density, seed)
        nbr, nbc = Af.nb_rows, Af.nb_cols
        log(f"leaf {leaf}: {n}^2 density {density} seed {seed}: {int(Af.nnz)} blocks, "
            f"{pc} products, {oc} output blocks, B row cap {mbr}")
        for tier in TIERS:
            _, _, prec, at, bt = pf._operands(Af.data, Af.data, leaf, tier, 0.5)
            nbytes = at.numel() * at.element_size() + bt.numel() * bt.element_size() \
                + oc * leaf * leaf * 4
            bnd = bound(2 * leaf**3 * pc, nbytes, pf.product_route(leaf, tier))
            if on_card(device):
                def run(tier=tier, at=at, bt=bt, prec=prec):
                    return pf.launch(plan.out_ids, plan.tables, at, bt, oc, nbr, nbc, mbr,
                                     prec)
                cfg = pf.launch_config(leaf, prec, mbr,
                                       pf.launch_shape(leaf, prec, oc, nbr, nbc, bt.shape[0]))
            else:
                def run(tier=tier):
                    return pf.fine_spgemm(Af.ids, Af.data, Af.ids, Af.data, plan.out_ids, nbr,
                                          nbr, nbc, oc, mbr, mbr, precision=tier,
                                          block_size=leaf, out_layout="flat", alpha=0.5,
                                          tables=plan.tables)
                cfg = {}
            ms, times = card_time_ms(run, device)
            ns_sm = None if ms is None else ms * 1e6 * SMS / pc
            res[(leaf, tier)] = dict(ms=ms, spread=max(times) - min(times) if times else None,
                                     pairs=pc, ns_per_product_per_sm=ns_sm, bound=bnd,
                                     config=cfg)
            per = "" if ns_sm is None else f", {ns_sm:.1f} ns per product per SM, " \
                f"{100 * bnd[0] / ms:.1f}% of bound"
            log(f"  {tier:8s} kernel alone {fmt_ms(ms)}{per}; bound {bnd[0]:.4f} ms "
                f"({bnd[1]}); {cfg}")
            if sweep and on_card(device) and hasattr(pf, "slot_chunks"):
                res.update(sweep_launch(plan, at, bt, oc, nbr, nbc, mbr, prec, leaf, tier))
        del plan, Af
        if on_card(device):
            torch.cuda.empty_cache()
    log(f"card: {card}")
    return res


if __name__ == "__main__":
    main(sweep="--no-sweep" not in sys.argv[1:])
