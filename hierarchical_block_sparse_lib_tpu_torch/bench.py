"""Benchmark suite (BASELINE.md B1-B4) on one CUDA card: the port of
``bench.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.bench [--quick] [--precision highest|default]

Prints ONE JSON line to stdout, with bench.py's four keys:
  {"metric": "B2_hierarchical_spgemm_effective_gflops", "value": N,
   "unit": "GFLOP/s", "vs_baseline": N}
Detail goes to stderr: each stage logs the backend that executes
(`resolve_backend`), its counters, the kernel launches per call (read
from the wrappers' ``.launches``) and each time's median beside its min
and max, then one line ``[stage] {json}`` with all of it.

Headline: the configured B2 (BASELINE.json:8: random 16384^2, 5% block
density, leaf 32, seed 2), 2*32^3 FLOPs per leaf pair over the time of
the best of its four paths (`b2_leaf32`).  `vs_baseline`: the dense
16384^2 product's time at the same precision over that best time.

Timing: CUDA events around each call, the median of 7 after 2 warm-up
calls (`utils/profiling.py::cuda_time_ms`).  The calls a stage compares
(unplanned and planned, routed and local, a path and the others of its
stage) are measured in turns, in order and then in reverse order, and a
call's time is the median of its two turns' medians.  bench.py's chained
`fori_loop` differential existed for the TPU's remote backend, which
served cached results and whose `block_until_ready` did not block; CUDA
has neither quirk.

Unlike bench.py, a stage that fails ends the run with a non-zero exit:
no retry, no swallowed exception, no headline taken from another stage,
and no amortized upper bound in place of a time.

The stage functions take `device=` and build their inputs there (the
card by default).  On the CPU they run the kernels' plain versions and
return their counters with no times; the tests call them so at cut
sizes.  Importing this module runs nothing.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import resolve_device
from hierarchical_block_sparse_lib_tpu_torch.kernels import (
    pallas_gemm_fine,
    pallas_gemm_groups,
    pallas_gemm_rows,
    pallas_gemm_stream,
    pallas_norms,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.slab import plan_colslab
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    matmul_precision,
    plan_spgemm,
    plan_spgemm_ex,
    resolve_backend,
)
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route
from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import card_line, cuda_time_ms, log

METRIC = "B2_hierarchical_spgemm_effective_gflops"
FLAGS = ("pair_overflow", "out_overflow", "row_overflow", "plan_mismatch")


def kernel_wrappers() -> dict:
    """Kernel name -> the wrapper whose `.launches` counts its launches
    (the kernels the bench's paths can reach)."""
    return {
        "fine_spgemm": pallas_gemm_fine.fine_spgemm,
        "rows_spgemm": pallas_gemm_rows.rows_spgemm,
        "groups_spgemm": pallas_gemm_groups.groups_spgemm,
        "gather_gemm_accumulate_stream": pallas_gemm_stream.gather_gemm_accumulate_stream,
        "block_frob_squared": pallas_norms.block_frob_squared,
        "norms_and_keep": pallas_norms.norms_and_keep,
    }


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def launches_since(before: dict) -> dict:
    """The kernels launched since `launch_counts()` gave `before`."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def launched_by(fn):
    """(fn(), {kernel: launches} of that one call)."""
    before = launch_counts()
    out = fn()
    return out, launches_since(before)


def time_in_turns(calls: dict, device, warmup: int = 2, reps: int = 7) -> dict:
    """CUDA-event times of each call, measured in order and then in
    reverse order: name -> {"ms": the median of the two turns' medians,
    "turns": [[median, min, max] of each turn]}.  Off the card, where no
    device time exists, name -> None."""
    if torch.device(device).type != "cuda":
        return {name: None for name in calls}
    turns = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            med, samples = cuda_time_ms(calls[name], warmup, reps)
            turns[name].append([med, min(samples), max(samples)])
    return {name: {"ms": statistics.median(t[0] for t in tt), "turns": tt}
            for name, tt in turns.items()}


def ms(t):
    return None if t is None else t["ms"]


def rate(flops: float, t):
    """GFLOP/s of `flops` in time `t` (None off the card)."""
    return None if t is None else flops / t["ms"] / 1e6


def fmt(t) -> str:
    if t is None:
        return "not measured (no card)"
    return f"{t['ms']:.3f} ms (turns " + ", ".join(
        f"{m:.3f} [min {lo:.3f}, max {hi:.3f}]" for m, lo, hi in t["turns"]) + ")"


def check_info(label: str, info, pairs=None, out=None) -> None:
    """Raise when a MultiplyInfo sets a flag, or when its counters differ
    from the host plan's (pairs, out)."""
    flags = [f for f in FLAGS if bool(getattr(info, f))]
    got = (int(info.n_block_pairs), int(info.n_out_blocks))
    if flags or (pairs is not None and got != (pairs, out)):
        raise AssertionError(f"{label}: flags {flags}, counters {got}, host plan ({pairs}, {out})")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def dense_operand(n: int, precision: str, device) -> torch.Tensor:
    """An n x n N(0, 1e-4) operand of a dense anchor, made on the device
    from seed 0 (its values do not change its time): f32, or bf16 at
    "default", where the product is the single bf16 pass that the port's
    "default" tier means."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((n, n), generator=g, device=device) * 1e-2
    return x.to(torch.bfloat16) if precision == "default" else x


def dense_product(x: torch.Tensor, y: torch.Tensor, precision: str) -> torch.Tensor:
    """torch.matmul at a tier: TF32 off for the call at "highest" (the
    global flags restored after), one bf16 pass on bf16 operands at
    "default"."""
    with matmul_precision(precision, x.device):
        return torch.matmul(x, y)


def bench_spgemm(A, name: str, precision: str = "highest", leaf=None, also=None) -> dict:
    """C = A @ A through `spgemm`, unplanned and planned (`make_plan`, the
    fixed-structure regime), in turns with the calls in `also` (name ->
    callable; their times land in the record's "times").  With
    ``leaf=(b_fine, fine_pairs, occ)`` also the leaf-granularity counter:
    `n_leaf_multiplies` from the occupancy masks must equal the fine host
    plan's pairs (bench.py:177-264)."""
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    b = A.block_size
    # Local structures (banded B1) also get a row-group plan: auto
    # dispatch then takes the group kernel.
    gplan = hbsm.plan_groups(A, A)
    gcaps = gplan.caps if gplan is not None else None
    backend = resolve_backend(b, A.dtype, A.nb_cols, pc, row_caps=(mbr, mcr), group_caps=gcaps)
    log(f"{name}: executing backend = {backend}")
    kw = dict(row_caps=(mbr, mcr), group_caps=gcaps, precision=precision)
    plan = hbsm.make_plan(A, A, pc)
    calls = {
        "unplanned": lambda: hbsm.spgemm(A, A, pc, oc, **kw),
        "planned": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, **kw),
    }
    launches = {}
    for key, call in calls.items():
        (_, info), launches[key] = launched_by(call)
        check_info(f"{name} {key}", info, pc, oc)
    res = dict(name=name, blocks=int(A.nnz), pairs=pc, out=oc, row_caps=[mbr, mcr],
               groups=None if gcaps is None else list(gcaps), backend=backend,
               launches=launches)
    log(f"{name}: blocks={res['blocks']} pairs={pc} out={oc} row_caps=({mbr},{mcr}) "
        f"groups={gcaps}; kernel launches per call {launches}")
    if leaf is not None:
        b_fine, fine_pairs, occ = leaf
        # The occupancy-tracked counter must equal the host plan at fine
        # granularity (untimed).
        _, info = hbsm.spgemm(A, A, pc, oc, a_leaf_occ=occ, b_leaf_occ=occ)
        n_leaf = int(info.n_leaf_multiplies)
        if n_leaf != fine_pairs:
            raise AssertionError(f"{name}: {n_leaf} leaf multiplies, fine host plan {fine_pairs}")
        res.update(leaf_b=b_fine, leaf_pairs=n_leaf)
    times = time_in_turns({**calls, **(also or {})}, A.device)
    flops = 2 * b**3 * pc
    t, tp = times["unplanned"], times["planned"]
    res.update(time_ms=ms(t), time_planned_ms=ms(tp), eff_gflops=rate(flops, t),
               planned_gflops=rate(flops, tp), times=times)
    log(f"{name}: unplanned {fmt(t)}; planned (frozen symbolic) {fmt(tp)}")
    if t is not None:
        log(f"{name}: eff {res['eff_gflops']:.1f} GFLOP/s unplanned, "
            f"{res['planned_gflops']:.1f} planned; {pc / t['ms'] * 1e3:,.0f} block GEMMs/s")
    if leaf is not None:
        log(f"{name} leaf-{b_fine} accounting: {n_leaf} leaf GEMMs"
            + ("" if t is None else
               f", honest eff {2 * b_fine**3 * n_leaf / t['ms'] / 1e6:.1f} GFLOP/s")
            + f" (tile padding inflation {flops / max(1, 2 * b_fine**3 * n_leaf):.1f}x)")
    return res


def bench_colslab(n: int, density: float, n_slabs: int, precision: str = "highest",
                  seed: int = 4, device=None) -> dict:
    """B4 at the configured near-dense size through the column-slab tier
    (BASELINE.json:10, bench.py:267-300): `plan_colslab`, then
    `spgemm_colslab(plan=)`, each slab on the row-panel kernel."""
    A = gen.random_block_matrix(n, 128, density, seed=seed, device=device)
    plan = plan_colslab(A, A, n_slabs)
    sl = plan.slabs[0]
    backend = resolve_backend(128, A.dtype, sl.j1 - sl.j0, sl.pair_cap, row_caps=sl.row_caps)
    log(f"B4 {n}^2 {density:.0%}: executing backend = {backend} (each slab); "
        f"blocks={int(A.nnz)} pairs={plan.total_pairs} out={plan.n_out} slabs={n_slabs}")
    call = lambda: hbsm.spgemm_colslab(A, A, plan=plan, precision=precision)  # noqa: E731
    (_, info), launches = launched_by(call)
    check_info(f"B4 {n}^2 colslab", info, plan.total_pairs, plan.n_out)
    t = time_in_turns({"colslab": call}, A.device)["colslab"]
    eff = rate(2 * 128**3 * plan.total_pairs, t)
    log(f"B4 near-dense({n}, {density:.0%}) x{n_slabs} slabs: kernel launches per call "
        f"{launches}; {fmt(t)}" + ("" if t is None else f", eff {eff:.1f} GFLOP/s"))
    return dict(name=f"B4-{n}", blocks=int(A.nnz), pairs=plan.total_pairs, out=plan.n_out,
                slabs=n_slabs, backend=backend, launches={"colslab": launches},
                time_ms=ms(t), eff_gflops=eff, times={"colslab": t})


def bench_dense_equiv(n: int, precision: str = "highest", device=None):
    """The dense n x n product at the same precision, the vs_baseline
    (bench.py:303-320): (ms, GFLOP/s), both None off the card."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None, None
    x = dense_operand(n, precision, device)
    t = time_in_turns({"dense": lambda: dense_product(x, x, precision)}, device)["dense"]
    log(f"dense {n}x{n} ({precision}): {fmt(t)} -> {rate(2 * n**3, t):.0f} GFLOP/s")
    return t["ms"], rate(2 * n**3, t)


def bench_dense_colslab(n: int, n_slabs: int, precision: str = "highest", device=None):
    """The same-size dense anchor of B4full (bench.py:323-353): the
    slab-wise dense product, n_slabs products [n, n] @ [n, n / n_slabs]
    with A resident, timed as one slab times n_slabs: (ms, GFLOP/s), both
    None off the card."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None, None
    w = n // n_slabs
    x = dense_operand(n, precision, device)
    t = time_in_turns({"slab": lambda: dense_product(x, x[:, :w], precision)}, device)["slab"]
    dt = t["ms"] * n_slabs
    log(f"dense {n}x{n} ({precision}, {n_slabs} slabs): one slab {fmt(t)} -> "
        f"{dt:.1f} ms, {2 * n**3 / dt / 1e6:.0f} GFLOP/s")
    return dt, 2 * n**3 / dt / 1e6


def b3_input(n: int, bw: int, device=None):
    """bench.py's B3 input (bench.py:367-380): a band of half-width `bw`
    at leaf 16 coarsened to 128, symmetrised, scaled to unit Frobenius
    norm and shifted by I/2."""
    b = 128
    A = gen.banded_block_matrix(n, bw, b, device=device)
    A = hbsm.add(A, hbsm.transpose(A), alpha=0.5, beta=0.5)
    A = hbsm.scale(A, 1.0 / float(np.sqrt(float(hbsm.frob_squared(A)))))
    return hbsm.add(A, hbsm.eye(n, b, device=A.device), beta=0.5, cap=A.cap + n // b)


def bench_truncation_pipeline(device=None, n: int = 4096, bw: int = 256, steps: int = 5,
                              tau: float = 1e-6) -> dict:
    """B3: repeated C = A*A with norm-based dropping (BASELINE.json:9,
    bench.py:356-443): `steps` SP2 steps per iteration through
    `purify_scan` at the exact capacities of `profile_purify`, unplanned
    and planned (`plan_purify`, the fixed-structure regime) in turns.  The
    two must be bitwise equal, with every overflow flag clean."""
    A = b3_input(n, bw, device)
    kw = dict(target_trace=n / 2)
    prof = hbsm.profile_purify(A, steps, tau, **kw)
    kw.update(prof.kwargs())
    backend = resolve_backend(128, A.dtype, A.nb_cols, prof.pair_cap, row_caps=prof.row_caps)
    log(f"B3: executing backend = {backend}; capacity profile: pairs/step={prof.per_step_pairs} "
        f"union={prof.per_step_out} kept={prof.per_step_kept} -> caps pair={prof.pair_cap} "
        f"out={prof.out_cap} cap={prof.cap} rows={prof.row_caps}")
    plans = hbsm.plan_purify(A, steps, tau, prof, target_trace=n / 2)
    calls = {"unplanned": lambda: hbsm.purify_scan(A, steps, tau, **kw),
             "planned": lambda: hbsm.purify_scan(A, steps, tau, plans=plans, **kw)}
    (xu, su), launches_u = launched_by(calls["unplanned"])
    (xp, sp), launches_p = launched_by(calls["planned"])
    for label, st in (("unplanned", su), ("planned", sp)):
        bad = [f for f in ("pair_overflow", "out_overflow", "repack_overflow", "plan_mismatch")
               if bool(getattr(st, f).any())]
        if bad:
            raise AssertionError(f"B3 {label} scan flags {bad}")
    if not (torch.equal(xu.ids, xp.ids) and torch.equal(xu.data, xp.data)):
        raise AssertionError("B3 planned and unplanned scans are not bitwise equal")
    pairs = int(su.n_block_pairs.sum())
    times = time_in_turns(calls, A.device)
    t, tp = times["unplanned"], times["planned"]
    log(f"B3 truncation pipeline ({steps} sp2 steps @ {n}, b=128): {pairs} pair GEMMs, "
        f"kernel launches per scan {launches_u} unplanned, {launches_p} planned; planned == "
        f"unplanned bitwise; unplanned {fmt(t)}; planned {fmt(tp)}")
    return dict(name="B3", blocks=int(A.nnz), backend=backend,
                per_step_pairs=list(prof.per_step_pairs), per_step_out=list(prof.per_step_out),
                per_step_kept=list(prof.per_step_kept), pair_cap=prof.pair_cap,
                out_cap=prof.out_cap, cap=prof.cap, row_caps=list(prof.row_caps), pairs=pairs,
                launches={"unplanned": launches_u, "planned": launches_p},
                time_ms=ms(t), time_planned_ms=ms(tp), times=times)


def b2_tile128(precision: str = "highest", device=None, n: int = 16384,
               density: float = 0.05) -> dict:
    """B2 generated at 128-wide tiles (bench.py:477-481): the machine
    throughput row, and the dense product of the same order
    (vs_baseline's numerator)."""
    A = gen.random_block_matrix(n, 128, density, seed=2, device=device)
    res = bench_spgemm(A, f"B2-tile128 random({n}, {density:.0%}@128)", precision)
    res["dense_n"] = n
    res["dense_ms"], res["dense_gflops"] = bench_dense_equiv(n, precision, A.device)
    return res


def b2_leaf32(precision: str = "highest", device=None, n: int = 16384,
              density: float = 0.05) -> dict:
    """B2 at its configured granularity (BASELINE.json:8, bench.py:482-688):
    random n^2 at 5% block density, leaf 32, seed 2, through four paths:
    direct `spgemm` at b=32 (auto -> "fine"), the flat-resident fine chain
    (`fine_matmul(plan=)`), `kpack_spgemm`, and the product coarsened to
    128-wide tiles with leaf tracking.  The paths are held against each
    other; the best one's honest rate, 2*32^3*fine_pairs / time, is the
    headline."""
    bf, f = 32, 4
    A32 = gen.random_block_matrix(n, bf, density, seed=2, device=device)
    fine_pairs, _ = plan_spgemm(A32, A32)
    pcd, ocd, mbrd, mcrd = plan_spgemm_ex(A32, A32)
    caps = (mbrd, mcrd)
    A32f = hbsm.fine_pack(A32)
    fplan = hbsm.make_fine_plan(A32, A32, pcd, ocd, caps)
    kplan = hbsm.plan_kpack(A32, A32, tile=128, n_groups=32)
    log(f"B2-leaf32 kpack plan: tiles={kplan.n_tiles} a_cols={kplan.n_a_cols} "
        f"b_rows={kplan.n_b_rows} panel_inflation={kplan.inflation:.2f}x "
        f"(fine pairs={fine_pairs})")
    if kplan.n_leaf_pairs != fine_pairs:
        raise AssertionError(f"kpack leaf pairs {kplan.n_leaf_pairs} vs fine pairs {fine_pairs}")
    flat = lambda: hbsm.fine_matmul(A32f, A32f, pcd, ocd, caps, precision=precision,  # noqa: E731
                                    plan=fplan)
    kpack = lambda: hbsm.kpack_spgemm(A32, A32, kplan, precision=precision)  # noqa: E731
    (_, info), flat_launches = launched_by(flat)
    check_info("B2-leaf32 fine-flat planned", info, pcd, ocd)
    (_, info), kpack_launches = launched_by(kpack)
    check_info("B2-leaf32 kpack", info)
    log(f"B2-leaf32 fine-flat: executing backend = fine (fine_matmul); kpack: torch.bmm over "
        f"packed panels; kernel launches per call: fine-flat {flat_launches}, "
        f"kpack {kpack_launches}")
    res_d = bench_spgemm(A32, "B2-leaf32 direct(b=32)", precision,
                         also={"fine_flat": flat, "kpack": kpack})
    t_flat, t_k = res_d["times"]["fine_flat"], res_d["times"]["kpack"]
    honest = lambda t: rate(2 * bf**3 * fine_pairs, t)  # noqa: E731
    log(f"B2-leaf32 fine-flat planned (flat-resident chain): {fmt(t_flat)}"
        + ("" if t_flat is None else f", honest leaf-32 eff {honest(t_flat):.1f} GFLOP/s"))
    log(f"B2-leaf32 kpack (packed contraction): {fmt(t_k)}"
        + ("" if t_k is None else f", honest leaf-32 eff {honest(t_k):.1f} GFLOP/s"))

    # Numerics, untimed and at "highest": the flat path against the direct
    # path, kpack against the coarsened path, and the direct product
    # coarsened against kpack (kpack's tiles are the fine support rounded
    # up to tiles).
    Cd, _ = hbsm.spgemm(A32, A32, pcd, ocd, row_caps=caps)
    Cf, _ = hbsm.fine_matmul(A32f, A32f, pcd, ocd, caps, plan=fplan)
    err_flat = rel_err(hbsm.fine_unpack(Cf).data, Cd.data)
    del Cf, A32f, fplan
    log(f"B2-leaf32 fine-flat vs direct rel err: {err_flat:.1e}")
    if err_flat >= 1e-5:
        raise AssertionError(f"B2-leaf32 fine-flat vs direct rel err {err_flat:.1e}")
    Ac, occ = hbsm.coarsen(A32, f, cap=hbsm.plan_coarsen(A32, f), track_leaves=True)
    res_n = bench_spgemm(Ac, "B2-leaf32 naive(coarsen->128)", precision,
                         leaf=(bf, fine_pairs, occ))
    Ck, _ = hbsm.kpack_spgemm(A32, A32, kplan)
    pc, oc, mbr, mcr = plan_spgemm_ex(Ac, Ac)
    Cc, _ = hbsm.spgemm(Ac, Ac, pc, oc, row_caps=(mbr, mcr))
    del Ac, occ
    err_k = rel_err(hbsm.to_dense(Ck), hbsm.to_dense(Cc))
    del Cc
    log(f"B2-leaf32 kpack vs coarsened-path rel err: {err_k:.1e}")
    if err_k >= 1e-4:
        raise AssertionError(f"B2-leaf32 kpack vs coarsened rel err {err_k:.1e}")
    Cd128 = hbsm.coarsen(Cd, f, cap=hbsm.plan_coarsen(Cd, f))
    nt = kplan.n_tiles
    if int(Cd128.nnz) != nt or not torch.equal(Cd128.ids[:nt], Ck.ids[:nt]):
        raise AssertionError(f"B2-leaf32 direct product coarsened holds {int(Cd128.nnz)} tiles, "
                             f"kpack {nt}, or other ids")
    err_d = rel_err(Cd128.data[:nt], Ck.data[:nt])
    log(f"B2-leaf32 direct vs kpack rel err: {err_d:.1e}")
    if err_d >= 1e-4:
        raise AssertionError(f"B2-leaf32 direct vs kpack rel err {err_d:.1e}")

    res = dict(name="B2-leaf32", fine_pairs=int(fine_pairs), kpack_inflation=kplan.inflation,
               kpack_tiles=nt, direct=res_d, naive=res_n,
               backend={"direct_b32": res_d["backend"], "fine_flat": "fine",
                        "kpack": "torch.bmm", "coarsen": res_n["backend"]},
               launches={"fine_flat": flat_launches, "kpack": kpack_launches},
               fine_flat_ms=ms(t_flat), kpack_ms=ms(t_k),
               best_path=None, best_ms=None, best_honest_gflops=None)
    if t_flat is None:
        return res
    # Headline = the best honest path; both regimes of the two
    # enumeration paths (kpack's plan is its one regime).
    cands = {
        "direct_b32": min(res_d["time_ms"], res_d["time_planned_ms"]),
        "fine_flat": t_flat["ms"],
        "kpack": t_k["ms"],
        "coarsen": min(res_n["time_ms"], res_n["time_planned_ms"]),
    }
    best = min(cands, key=cands.get)
    res.update(paths_ms=cands, best_path=best, best_ms=cands[best],
               best_honest_gflops=2 * bf**3 * fine_pairs / cands[best] / 1e6)
    log(f"B2-leaf32 BEST path: {best} t={cands[best]:.3f} ms honest leaf-32 eff="
        f"{res['best_honest_gflops']:.1f} GFLOP/s (paths {cands})")
    return res


def b2_default(device=None, n: int = 16384, density: float = 0.05) -> dict:
    """B2-tile128 at precision="default" (bench.py:690-698): one bf16
    pass, the error-tolerant rate."""
    A = gen.random_block_matrix(n, 128, density, seed=2, device=device)
    return bench_spgemm(A, "B2-tile128 (precision=default)", "default")


def b1(precision: str = "highest", device=None, n: int = 4096, bw: int = 64) -> dict:
    """B1 (BASELINE.json:7, bench.py:700-764): banded n^2, bandwidth `bw`,
    leaf 16 coarsened x8 with leaf tracking (both counters honest), and
    its dense-band tier (`band_mm`) in turns with it, held against the
    block path first."""
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A16 = hbsm.from_coo(r, c, v, n, block_size=16, device=device)
    fine_pairs, fine_out = plan_spgemm(A16, A16)
    A, occ = hbsm.coarsen(A16, 8, cap=hbsm.plan_coarsen(A16, 8), track_leaves=True)
    Ab = hbsm.band_from_blocks(A16, bw)
    Cb = hbsm.band_mm(Ab, Ab, precision=precision)
    Cref, _ = hbsm.spgemm(A16, A16, fine_pairs, fine_out, backend="xla")
    err = rel_err(hbsm.band_to_dense(Cb), hbsm.to_dense(Cref))
    del Cb, Cref
    if err >= 1e-4:
        raise AssertionError(f"B1 band tier vs block path rel err {err:.1e}")
    band = lambda: hbsm.band_mm(Ab, Ab, precision=precision)  # noqa: E731
    res = bench_spgemm(A, f"B1 banded({n}, bw{bw})", precision, leaf=(16, fine_pairs, occ),
                       also={"band_mm": band})
    tb = res["times"]["band_mm"]
    res["band_backend"] = "torch.bmm"
    res["band_ms"] = ms(tb)
    res["band_honest_gflops"] = rate(2 * 16**3 * fine_pairs, tb)
    log(f"B1 band tier (strip panels, torch.bmm): {fmt(tb)}"
        + ("" if tb is None else f", honest leaf-16 eff {res['band_honest_gflops']:.1f} GFLOP/s")
        + f" (rel err vs block path {err:.1e})")
    return res


def routed_1dev(precision: str = "highest", device=None, n: int = 16384,
                density: float = 0.05) -> dict:
    """The routed exchange on a one-shard mesh (bench.py:780-823): B2-tile128
    through `plan_route` and `dist_spgemm_routed`, unfrozen and frozen
    (`freeze_route_plan`), in turns with the planned local product.  The
    frozen run must report no stale plan and no overflow."""
    A = gen.random_block_matrix(n, 128, density, seed=2, device=device)
    mesh1 = dist.make_mesh(1, device=device)
    Ad = dist.distribute(A, mesh1)
    plan = route.plan_route(Ad, Ad, 1)
    frozen = route.freeze_route_plan(Ad, Ad, plan)
    backend = resolve_backend(128, A.dtype, A.nb_cols, plan.stage_pair_caps[0],
                              row_caps=plan.stage_row_caps[0])
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    gplan = hbsm.plan_groups(A, A)
    kw = dict(row_caps=(mbr, mcr), group_caps=None if gplan is None else gplan.caps,
              precision=precision)
    lplan = hbsm.make_plan(A, A, pc)
    calls = {
        "routed_unfrozen": lambda: route.dist_spgemm_routed(Ad, Ad, mesh1, plan,
                                                            precision=precision),
        "routed_frozen": lambda: route.dist_spgemm_routed(Ad, Ad, mesh1, frozen,
                                                          precision=precision),
        "local_planned": lambda: hbsm.spgemm(A, A, pc, oc, plan=lplan, **kw),
    }
    launches = {}
    for key in ("routed_unfrozen", "routed_frozen"):
        (_, st), launches[key] = launched_by(calls[key])
        if bool(st["plan_mismatch"]) or bool(st["overflow"]) or int(st["n_block_pairs"]) != pc:
            raise AssertionError(f"B2 routed 1-dev mesh ({key}): plan_mismatch "
                                 f"{bool(st['plan_mismatch'])}, overflow {bool(st['overflow'])}, "
                                 f"pairs {int(st['n_block_pairs'])} vs {pc}")
    (_, info), launches["local_planned"] = launched_by(calls["local_planned"])
    check_info("B2 local planned", info, pc, oc)
    times = time_in_turns(calls, A.device)
    log(f"B2 routed 1-dev mesh: executing backend = {backend} (each stage); stages "
        f"{list(plan.stages)}, pairs {plan.total_pairs}, out_cap {plan.out_cap}; flags clean; "
        f"kernel launches per call {launches}")
    base = times["local_planned"]
    for key in ("routed_unfrozen", "routed_frozen"):
        log(f"B2 routed 1-dev mesh ({key.split('_')[1]}): {fmt(times[key])}"
            + ("" if base is None else
               f" vs planned local {base['ms']:.3f} ms ({times[key]['ms'] / base['ms']:.2f}x)"))
    return dict(name="B2-routed-1dev", blocks=int(A.nnz), pairs=pc, out=oc, backend=backend,
                route=dict(stages=list(plan.stages), total_pairs=plan.total_pairs,
                           out_cap=plan.out_cap, stage_pair_caps=list(plan.stage_pair_caps),
                           stage_out_caps=list(plan.stage_out_caps),
                           stage_row_caps=[list(rc) for rc in plan.stage_row_caps],
                           union_c_row_max=plan.union_c_row_max,
                           blocks_routed=plan.blocks_routed, blocks_ring=plan.blocks_ring),
                flags=[], launches=launches, times=times,
                **{f"{k}_ms": ms(t) for k, t in times.items()})


def b3(device=None, n: int = 4096, bw: int = 256) -> dict:
    """B3 (bench.py:830): the truncation pipeline, at "highest" whatever
    the bench's --precision, as in bench.py."""
    return bench_truncation_pipeline(device, n=n, bw=bw)


def b4(precision: str = "highest", device=None, n: int = 8192, density: float = 0.5) -> dict:
    """B4 at its warm-up scale (bench.py:832-839): random n^2 at 50% block
    density, leaf 128, seed 4, one row-panel product."""
    A = gen.random_block_matrix(n, 128, density, seed=4, device=device)
    return bench_spgemm(A, f"B4 near-dense({n}, {density:.0%})", precision)


def b4full(precision: str = "highest", device=None, n: int = 32768, n_slabs: int = 8) -> dict:
    """B4 at its configured size (BASELINE.json:10, bench.py:843-849):
    32768^2 at 50% through 8 column slabs."""
    return bench_colslab(n, 0.5, n_slabs, precision, device=device)


def b4_anchor(precision: str = "highest", device=None, b4full_ms=None, n: int = 32768,
              n_slabs: int = 8) -> dict:
    """The same-size dense anchor of B4full (bench.py:766-779): the
    slab-wise dense product, and B4full's speed-up over it."""
    dt, gflops = bench_dense_colslab(n, n_slabs, precision, device)
    vs = None if dt is None or b4full_ms is None else dt / b4full_ms
    if vs is not None:
        log(f"B4full({n}) vs same-size dense: {vs:.1f}x faster")
    backend = "torch.matmul, " + ("one bf16 pass" if precision == "default" else "TF32 off")
    return dict(name=f"B4-dense-{n}", backend=backend, time_ms=dt, gflops=gflops,
                b4full_vs_dense=vs)


def stages(quick: bool, precision: str, device, results: dict) -> list:
    """(results key, call) of each stage in bench.py's order
    (bench.py:463-481, 825-851)."""
    p = precision
    if quick:
        # bench.py:463-470: one stage, sized so the work dominates.
        return [("B2quick", lambda: b2_tile128(p, device, n=8192, density=0.15))]
    out = [("B2", lambda: b2_tile128(p, device)),
           ("B2leaf32", lambda: b2_leaf32(p, device))]
    if p != "default":
        out.append(("B2_default", lambda: b2_default(device)))
    return out + [
        ("B1", lambda: b1(p, device)),
        ("routed_1dev", lambda: routed_1dev(p, device)),
        ("B3", lambda: b3(device)),
        ("B4", lambda: b4(p, device)),
        ("B4full", lambda: b4full(p, device)),
        ("B4_anchor", lambda: b4_anchor(p, device, b4full_ms=results["B4full"]["time_ms"])),
    ]


def headline(results: dict) -> dict:
    """bench.py's JSON line (bench.py:862-885): the configured B2's honest
    leaf-32 rate on its best path, and the dense product's time over that
    path's; with --quick, the one stage's tile rate, as bench.py has it.
    No stage stands in for another."""
    if "B2quick" in results:
        b2 = results["B2quick"]
        value, t = b2["eff_gflops"], b2["time_ms"]
    else:
        b2 = results["B2"]
        value, t = results["B2leaf32"]["best_honest_gflops"], results["B2leaf32"]["best_ms"]
    return {"metric": METRIC, "value": round(value, 1), "unit": "GFLOP/s",
            "vs_baseline": round(b2["dense_ms"] / t, 3)}


def stage_row(key: str, res: dict) -> str:
    """One line of the closing table: wall seconds, backend, counters,
    each call's median [min, max] over both turns, kernel launches."""
    recs = [res] + [res[k] for k in ("direct", "naive") if k in res]
    counters = {k: r[k] for r in recs[::-1] for k in ("pairs", "out", "leaf_pairs",
                                                       "per_step_pairs", "fine_pairs") if k in r}
    counters.update({k: res[k] for k in ("best_path", "b4full_vs_dense") if res.get(k)})
    times = [f"{r.get('name', key)} {name} {t['ms']:.3f} [{min(x[1] for x in t['turns']):.3f}, "
             f"{max(x[2] for x in t['turns']):.3f}]"
             for r in recs for name, t in (r.get("times") or {}).items() if t is not None]
    if not times and res.get("time_ms") is not None:
        times.append(f"{res.get('name', key)} {res['time_ms']:.3f}")
    return (f"{key:11s} {res['wall_s']:6.1f} s  backend {res['backend']}  {counters}  ms: "
            f"{'; '.join(times) or 'not measured'}  launches {res['stage_launches']}")


def main(argv=None, device=None) -> int:
    """Run the stages; prints the headline line.  Exits 2 without a card
    (unless `device` names another, as the tests do)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--precision", default="highest", choices=("highest", "default"))
    args = ap.parse_args(argv)
    if device is None and not torch.cuda.is_available():
        log("bench: no CUDA device; nothing to run")
        return 2
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        + (f"{torch.cuda.get_device_name(dev)}: {card_line()}" if on_card else f"device {dev}"))
    results = {}
    t_run = time.perf_counter()
    for key, run in stages(args.quick, args.precision, dev, results):
        if on_card:
            torch.cuda.synchronize(dev)
        t0, before = time.perf_counter(), launch_counts()
        res = run()
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        res.update(wall_s=time.perf_counter() - t0, stage_launches=launches_since(before))
        results[key] = res
        log("[stage] " + json.dumps({"stage": key, **res}))
    log(f"stages ({time.perf_counter() - t_run:.1f} s; ms: the median of two turns' medians "
        f"of 7 CUDA-event times after 2 warm-ups [min, max]):")
    for key, res in results.items():
        log("  " + stage_row(key, res))
    print(json.dumps(headline(results)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
