#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero without its
final line):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the Hopper kernels from the sources in this checkout, one nvcc
   per source, all started together; print the three 128-tile kernels'
   launches per data type and tier (shared bytes, blocks per SM,
   registers, spills) and the tensor-core instructions in their SASS
   (HMMA from mma.sync, HGMMA from wgmma, counted by cuobjdump), which
   every instantiation of the row-panel, pair-stream and row-group
   kernels must have;
3. each kernel vs its plain PyTorch version at small shapes: the fine
   kernel at b in {16, 32, 64} x the three precision tiers (rectangular
   alpha != 1 operands with empty rows, the zero tail), then its edges at
   each leaf x tier x both layouts x the B row seen whole and capped at
   8: an A row longer than a shared-memory k-chunk, a C row cut by a
   chunk boundary, an empty A row with output slots that no product
   reaches, an empty C row, slots with one and with many products, a
   SENTINEL tail; the row-panel kernel at b=128 x the three tiers, bf16 data, the
   SpAMM skip, triu and the aligned accumulator, with union slots that no
   product reaches and a tail; both norm kernels, f32 and bf16; the
   pair-stream kernel at b in {128, 256} x the three tiers, bf16, a
   carry-in, padding pairs and an empty pair list; the v1 call chunked at
   64 pairs against one chunk, bitwise; both 128-tile kernels at their
   ring's edges (slots with 0, 1, 3, 4 and 7 products against a 3-slice
   ring, an A row of 300 entries, SpAMM skipping all of a slot's products,
   triu with the aligned accumulator, the stream at b=256 with a
   carry-in); the row-group kernel at b in
   {128, 256} x the three tiers and bf16, with a partial last group, a
   rectangular product and union slots; spgemm on the group kernel with a
   fused accumulate, and an undersized slab cap that must be flagged;
4. the B2 path at its configured size: random 16384^2, 5% block
   density, leaf 32, seed 2, through plan_spgemm_ex -> fine_pack ->
   make_fine_plan -> fine_matmul(plan=) -> fine_add -> fine_scale ->
   fine_unpack, held against an f64 dense oracle and the host plan's
   counters, with the fine kernel's launch count read around it;
5. the fine kernel vs its plain version at B2's shapes, bitwise
   determinism of a repeated planned multiply, and CUDA-event times;
6. one SP2 step through the port's entry (entry.py::entry: the graft
   entry's input, 1024^2, band 48, 16-blocks coarsened to 128) held
   against the f64 product of the same step;
7. the B3 path at its configured size (bench.py's truncation pipeline:
   4096^2 band 256, leaf 128, symmetrised, scaled, shifted; 5 SP2 steps
   at tau=1e-6): profile_purify against the JAX package's capacity
   profile, unplanned purify_scan, plan_purify, planned purify_scan with
   no host sync allowed; planned and unplanned bitwise equal, 5 launches
   of each kernel per scan, and the iterate against the port's float64
   path; launch counts read around the whole path;
8. the row-panel and norm kernels vs their plain versions at B3's
   step-2 shapes, and CUDA-event times of the scans, the kernels, their
   plain versions and one library call; the spread of products per slot
   at step 2; rows_spgemm at each step's shape, the call beside its
   kernel's profiler device time per launch and both bounds (FP32 FFMA,
   3xTF32); a torch.bmm over step 2's gathered pairs with TF32 off, as a
   yardstick;
9. purification at 1024^2 (tau=1e-7, 40 steps) against the spectral
   projector from an f64 eigendecomposition;
10. a torch.profiler trace of 10 planned B3 scans: device time by
    kernel, launches, and the device's idle share;
11. B3's input through `purify` (no row caps: the pair-stream kernel),
    5 steps, held against the rows-backend scan of phase 7: equal stats
    and ids, the iterate within 1e-5;
12. the configured B1 (bench.py:700-721: banded 4096^2, bandwidth 64,
    leaf 16, coarsened x8 with leaf tracking): plan_groups against the
    JAX package's plan, matmul and spgemm on the row-group kernel,
    unplanned and planned, against the host plans' counters (leaf
    multiplies included) and an f64 dense oracle; the group kernel vs
    plain, its device time per launch and both bounds; the same planned product through "rows" and "pallas" bitwise
    equal to "groups"; times of it on each of the three, and a
    torch.profiler breakdown of each;
13. B2-tile128 (bench.py:477: random 16384^2 at leaf 128, 5%, seed 2)
    without row caps, on the pair-stream kernel: counters, a repeated
    call bitwise equal, the product against the port's float64 path; the
    v1 call on the same pairs; both against their plain versions, with
    times, each call's kernel device time per launch and both bounds, a
    torch.bmm yardstick over the gathered pairs, and a torch.profiler
    breakdown of the planned product;
14. the fine kernel's micro-benchmarks: the four micro kernels (micro,
    e2, e3, e12) against their plain versions at small shapes (every
    mode, recipe, tier and do_adds; micro at reps 0, 1, 5 on shapes that
    cut its block tiles, "quad" bitwise equal to "wide" at 896; e3 with
    out-of-range, one-slot and empty indices, and one e3 call shown to be
    one launch of one kernel; e12 with random, one-slot and out-of-range
    slots and past one scan chunk, and one e12 call per tier shown to be
    one launch of one kernel), then the port's three measurement
    scripts at their own shapes (scripts/micro_fine_kernel.py,
    micro_fine_kernel2.py: each kernel against its plain version, its
    times, bound and library time in turns, and the torch-op probes; the micro kernels' launches counted
    around them; the micro kernels' profiler device times, e12's against
    both bounds), scripts/
    profile_fine_pieces.py: the planned B2 multiply in parts, and scripts/
    time_fine_kernel.py: the fine kernel alone at B2's structure for each
    leaf and tier, and its launch sizes swept;
15. (run after phase 13) the occupancy tiers and B4: B4 at 8192²
    (bench.py:831-840: random, 50% block density, leaf 128, seed 4) through
    the host plans, the backend auto picks, the planned spgemm and
    spgemm_colslab(n_slabs=4), against the counters, an f64 product and
    each other (bitwise), rows_spgemm against its chunked plain version;
    B4 at its configured 32768² (BASELINE.json:10) through plan_colslab(8)
    and spgemm_colslab on the row-panel kernel, against the plan's
    counters and an f64 product taken a slab of columns at a time; times
    in turns beside the dense anchors (TF32 off), the kernel's device time
    per launch and both bounds, the peak memory; B1's band tier and
    leafpack against the f64 oracle and phase 12's product; kpack at B2
    against phase 4's planned fine product coarsened; spmm and spmv at
    B2's A against f64;
16. (run after phase 15) the reference-shaped surface and the symmetric
    product: B1 through HierarchicalBlockSparseMatrix (Params(16),
    resize, assign_from_vectors, multiply) on the band tier, band-resident,
    its counter equal to the block path's leaf-16 pairs, against f64, its
    Frobenius norm read band-side, timed beside phase 12's planned product
    on "pallas"; B2 through the class (two multiplies of phase 4's A: one
    host plan, one fine_spgemm launch each, bitwise equal to
    spgemm(backend="fine", plan=), 335 999 pairs each, against f64, timed
    beside phase 4's planned fine_matmul), frob_block_trunc on a copy,
    get_all_values (triplets and peak host memory) and save/load bitwise;
    syrk at B3's input on the row-panel kernel's triu skip (pairs_upper
    against pairs_raw, against matmul(A, A, transpose_b=True) and f64, the
    kernel against its plain version, its device time per launch and both
    bounds); symmetric SP2 at B3 (profile_purify, plan_purify and
    purify_scan with symmetric=True, unplanned and planned with no host
    sync): fewer pairs per step than phase 7's scan and at least half, an
    exactly symmetric iterate within 1e-5 of the float64 path and of phase
    7's iterate, launches per scan, frob_block_trunc at b = 128 on
    norms_and_keep, and times in turns beside phase 7's planned scan;
17. (run after phase 16) the rest of the single-chip surface at B3's
    configured input: SpAMM (A @ A with tau halfway between two pair-norm
    products near the median) on "rows" and "xla", against plan_spamm
    (C++ and numpy), each other, spamm_error_bound and f64, one
    rows_spgemm launch, the kernel with its skip against its plain
    version, the planned call beside the planned unfiltered one, the
    kernel's device time and both bounds on the surviving pairs; the
    aligned accumulate (A @ A + D, D on the product's support) planned
    and planless against the generic accumulate and f64, one rows_spgemm
    launch and no other launch as long as one read of D, a missing
    product block flagged, times in turns; polynomial (pair-stream
    kernel), chebyshev_apply (Fermi, beta 6, scaled by gershgorin_bound)
    and inv_sqrt_newton_schulz (S = I + a symmetric band) at the caps
    their trajectories need, unplanned and planned (bitwise equal), their
    launches, call times and profiles, against f64 oracles; subtree
    truncation at level 3 of B3's step-1 product against host f64 node
    norms, frob_norm and nnz_blocks against the host; and
    scripts/purification_demo.py at 1024^2 against its tolerance.

Phase 2 also prints each fine-kernel launch's k-chunk, shared memory,
occupancy, registers and spills at B2's B row cap.  Prints the card line
and one JSON line of per-kernel results, then, as
the last line, ``{"ok": true, "device": {...}}``.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import (
    alternate,
    bound,
    card_line,
    cuda_time_ms,
    in_turns,
)

_CSRC = "hierarchical_block_sparse_lib_tpu_torch/kernels/csrc/"
_TPU = "hierarchical_block_sparse_lib_tpu/kernels/"
# name -> (source, TPU kernel it replaces)
KERNELS = {
    "fine_spgemm": (_CSRC + "gemm_fine.cu", _TPU + "pallas_gemm_fine.py:450"),
    "rows_spgemm": (_CSRC + "gemm_rows.cu", _TPU + "pallas_gemm_rows.py:549"),
    "block_frob_squared": (_CSRC + "norms.cu", _TPU + "pallas_norms.py:67"),
    "norms_and_keep": (_CSRC + "norms.cu", _TPU + "pallas_norms.py:92"),
    "gather_gemm_accumulate_stream": (
        _CSRC + "gemm_stream.cu", _TPU + "pallas_gemm_stream.py:189"),
    "groups_spgemm": (_CSRC + "gemm_groups.cu", _TPU + "pallas_gemm_groups.py:449"),
    "gather_gemm_accumulate": (_CSRC + "gemm_stream.cu", _TPU + "pallas_gemm.py:161"),
    "micro": (_CSRC + "micro_fine.cu", "scripts/micro_fine_kernel.py:53"),
    "e2": (_CSRC + "micro_fine.cu", "scripts/micro_fine_kernel2.py:45"),
    "e3": (_CSRC + "micro_fine.cu", "scripts/micro_fine_kernel2.py:73"),
    "e12": (_CSRC + "micro_fine.cu", "scripts/micro_fine_kernel2.py:107"),
}
MICRO_KERNELS = ("micro", "e2", "e3", "e12")
B3_KERNELS = ("rows_spgemm", "norms_and_keep", "block_frob_squared")
TOL = {"highest": 1e-5, "high": 1e-5, "default": 1e-4}
# Row-panel kernel vs plain version, relative to max|C|: both take the
# same (rounded) operands at every tier and sum f32 products in another
# order.
ROWS_TOL = 1e-5
# B3's capacity profile as the JAX package computes it (on the CPU,
# profile_purify(..., backend="xla") on bench.py's B3 input): per-step
# pairs, union and kept blocks; caps pair, out, iterate and rows.
B3_PROFILE = dict(
    per_step_pairs=(750, 2292, 4498, 4498, 4498),
    per_step_out=(268, 472, 644, 644, 644),
    per_step_kept=(268, 374, 374, 374, 424),
    pair_cap=4498, out_cap=644, cap=424, row_caps=(13, 25),
)
# B1 at leaf 128 as the JAX package plans it: plan_groups' fields, and
# (block pairs, output blocks, leaf-16 multiplies = plan_spgemm(A16, A16)).
B1_PLAN = dict(caps=(16, 47, 50, 77), slab_blocks=100, pairs=278)
B1_COUNTS = (278, 154, 20436)
# B2-tile128's (block pairs, output blocks), plan_spgemm in the JAX package.
B2T_COUNTS = (5156, 4415)
DEVICE = "cuda"


def block_matrix(ids, nbr, nbc, b, rng):
    """Block matrix on the card with the given sorted ids on an nbr x nbc
    block grid and dense N(0,1) blocks drawn from `rng`."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch import BlockMatrix

    ids = np.asarray(ids, dtype=np.int32)
    data = rng.standard_normal((ids.size, b, b)).astype(np.float32)
    return BlockMatrix(
        ids=torch.from_numpy(ids).to(DEVICE),
        data=torch.from_numpy(data).to(DEVICE),
        nnz=torch.tensor(ids.size, dtype=torch.int32, device=DEVICE),
        n_rows=nbr * b, n_cols=nbc * b, block_size=b,
    )


def random_pattern(nbr, nbc, b, density, seed, empty_rows=()):
    """Random block-sparse matrix with dense N(0,1) blocks; block rows in
    `empty_rows` hold nothing."""
    rng = np.random.default_rng(seed)
    n_blocks = max(1, int(round(density * nbr * nbc)))
    ids = np.sort(rng.choice(nbr * nbc, n_blocks, replace=False))
    return block_matrix(ids[~np.isin(ids // nbc, empty_rows)], nbr, nbc, b, rng)


def band_pattern(nbr, nbc, hw, b, seed):
    """Band of half-width `hw` blocks on an nbr x nbc block grid, dense
    N(0,1) blocks."""
    ids = [i * nbc + j for i in range(nbr)
           for j in range(max(0, i - hw), min(nbc, i + hw + 1))]
    return block_matrix(ids, nbr, nbc, b, np.random.default_rng(seed))


def pair_stream(A, B, pair_cap, out_cap):
    """spgemm's output-sorted block pairs of A @ B padded to `pair_cap`,
    and each pair's output slot (`out_cap` for a padding pair): the
    stream kernel's (a_idx, b_idx, seg)."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import first_of_run

    a_idx, b_idx, c_id, _, _ = hbsm.spgemm_symbolic(A, B, pair_cap)
    seg = torch.where(c_id != hbsm.SENTINEL, torch.cumsum(first_of_run(c_id), 0) - 1, out_cap)
    return a_idx, b_idx, seg.to(torch.int32)


def check_close(name, got, want, tol):
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max abs err {err:.3e} over tol {tol}")
    return err


def sass_counts(name):
    """Per kernel function of the built library `name`: its tensor-core
    instructions (HMMA from mma.sync, HGMMA from wgmma) and its FFMA, read
    from ``cuobjdump -sass``."""
    import os

    from torch.utils.cpp_extension import CUDA_HOME

    from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            counts[fn][0] += " HMMA." in line
            counts[fn][1] += " HGMMA." in line
            counts[fn][2] += " FFMA " in line
    return counts


def tile_kernel_report():
    """Phase 2: the tensor-core kernels' launches per data type and tier
    (shared bytes, blocks per SM, registers, spills), and the mma
    instructions in their SASS, which show that the tensor cores are
    reached."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_groups as pg
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as pr
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_stream as ps

    for label, mod, tiers in (("rows_spgemm", pr, ("highest", "high", "default")),
                              ("stream", ps, ("highest", "default")),
                              ("groups_spgemm", pg, ("highest", "high", "default"))):
        for dtype, prec in [(torch.float32, t) for t in tiers] + [(torch.bfloat16, "highest")]:
            print(f"[build] {label} {str(dtype)[6:]} {prec}: {mod.launch_config(dtype, prec)}")
    # Template arguments in the mangled names: data type and tier.
    tiers = {"IfLi0E": "f32 highest", "IfLi1E": "f32 high", "IfLi2E": "f32 default",
             "I13__nv_bfloat16Li0E": "bf16"}
    for name, kernel in (("gemm_rows", "rows_spgemm_kernel"), ("gemm_stream", "stream_kernel"),
                         ("gemm_groups", "groups_kernel")):
        for fn, (hmma, hgmma, ffma) in sass_counts(name).items():
            if kernel not in fn:
                continue
            tier = next(v for k, v in tiers.items() if kernel + k in fn)
            print(f"[build] SASS {kernel:18s} {tier:11s}: {hmma:4d} HMMA {hgmma:4d} HGMMA "
                  f"{ffma:5d} FFMA")
            if hmma + hgmma == 0:
                raise AssertionError(f"{kernel} {tier}: no tensor-core instruction in its SASS")


def small_shapes():
    """Phase 3: kernel vs plain version at small shapes."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
        fine_spgemm,
        fine_spgemm_reference,
    )
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

    for b in (16, 32, 64):
        A = random_pattern(8, 12, b, 0.3, seed=b, empty_rows=(1, 5))
        B = random_pattern(12, 6, b, 0.3, seed=b + 1, empty_rows=(2,))
        pc, oc, mbr, mcr = plan_spgemm_ex(A, B)
        out_cap = oc + 5  # five tail slots past the product support
        Af, Bf = hbsm.fine_pack(A), hbsm.fine_pack(B)
        plan = hbsm.make_fine_plan(Af, Bf, pc, out_cap, (mbr, mcr))
        args = (
            Af.ids, Af.data, Bf.ids, Bf.data, plan.out_ids,
            Af.nb_rows, Bf.nb_rows, Bf.nb_cols, out_cap, mbr, mcr,
        )
        exact = -0.5 * (
            hbsm.to_dense(A).double() @ hbsm.to_dense(B).double()
        )
        for prec in ("highest", "high", "default"):
            kw = dict(precision=prec, block_size=b, out_layout="flat",
                      alpha=-0.5, tables=plan.tables)
            got = fine_spgemm(*args, **kw)
            want = fine_spgemm_reference(*args, **kw)
            torch.cuda.synchronize()
            err = check_close(f"b={b} {prec}", got, want, TOL[prec])
            if torch.count_nonzero(got[oc:]) != 0:
                raise AssertionError(f"b={b} {prec}: tail slots not zero")
            C, info = hbsm.fine_matmul(
                Af, Bf, pc, out_cap, (mbr, mcr), alpha=-0.5, precision=prec
            )
            if not torch.equal(C.ids, plan.out_ids) or int(info.n_block_pairs) != pc:
                raise AssertionError(f"b={b} {prec}: ids or pair count differ")
            dense = hbsm.to_dense(hbsm.fine_unpack(C)).double()
            rel = float((dense - exact).abs().max() / exact.abs().max())
            print(f"  b={b:2d} {prec:8s} kernel-vs-plain max_abs_err={err:.3e}"
                  f"  vs f64 oracle rel={rel:.3e}")
            if prec == "highest" and rel > 1e-5:
                raise AssertionError(f"b={b}: rel err {rel:.3e} vs f64 oracle")
        small_fine_edges(b)


def small_fine_edges(b):
    """Phase 3: the fine kernel's edges against its plain version at leaf
    b, every tier, both layouts, with the B rows seen whole and capped at
    8: a 4 x 80 A whose row 0 holds all 80 entries (more than one
    k-chunk of staged A blocks, and a C row of more than CHUNK_SLOTS
    slots, so a chunk boundary inside it), row 1 empty (with two output
    slots that no product reaches), row 2 one entry (slots with one
    product), row 3 only entries whose B rows are empty (an empty C row),
    and a tail of five SENTINEL slots."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

    nbr, nbrB, nbc = 4, 80, 160
    rng = np.random.default_rng(100 + b)
    b_ids = np.sort(rng.choice(nbrB * nbc, nbrB * nbc // 10, replace=False))
    b_ids = b_ids[b_ids // nbc < 70]  # B rows 70..79 empty
    a_ids = list(range(80)) + [2 * nbrB + 5] + [3 * nbrB + k for k in (70, 75, 79)]
    A = block_matrix(a_ids, nbr, nbrB, b, rng)
    B = block_matrix(b_ids, nbrB, nbc, b, rng)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, B)
    support = hbsm.make_fine_plan(A, B, pc, oc, (mbr, mcr)).out_ids
    extra = torch.tensor([nbc + 3, nbc + 50], dtype=torch.int32, device=DEVICE)
    used = torch.sort(torch.cat([support, extra])).values
    out_ids = torch.cat([used, torch.full((5,), hbsm.SENTINEL, dtype=torch.int32,
                                          device=DEVICE)])
    out_cap = out_ids.shape[0]
    tables = pf.fine_tables(A.ids, B.ids, out_ids, nbr, nbrB, nbc, b)
    row0 = int(tables[4][1])
    if row0 <= pf.CHUNK_SLOTS or int(tables[4][4] - tables[4][3]) != 0:
        raise AssertionError(f"edge case: C row 0 has {row0} slots, row 3 not empty")
    a_idx, b_idx = pf.expand_pairs(A.ids, tables[1], tables[2], mbr)
    c_id = (A.ids[a_idx].long() // nbrB) * nbc + tables[3][b_idx].long()
    per_slot = torch.bincount(pf.pair_slots(out_ids, c_id.to(torch.int32), out_cap),
                              minlength=out_cap + 1)[:oc + 2]
    if not (per_slot == 0).any() or not (per_slot == 1).any() or per_slot.max() < 5:
        raise AssertionError(f"edge case: products per slot {per_slot.tolist()}")
    zero_slots = torch.cat([(per_slot == 0).nonzero().flatten(),
                            torch.arange(oc + 2, out_cap, device=DEVICE)])
    data = {"canonical": (A.data, B.data),
            "flat": (hbsm.fine_pack(A).data, hbsm.fine_pack(B).data)}
    for prec in ("highest", "high", "default"):
        kc = pf.launch_config(b, prec, mbr)["kc"]
        if kc >= 80:
            raise AssertionError(f"b={b} {prec}: k-chunk {kc} holds A's row 0 whole")
        for layout, (ad, bd) in data.items():
            for cap in (mbr, 1):
                args = (A.ids, ad, B.ids, bd, out_ids, nbr, nbrB, nbc, out_cap, cap, mcr)
                kw = dict(precision=prec, block_size=b, out_layout=layout, alpha=-0.5)
                got = pf.fine_spgemm(*args, **kw, tables=tables)
                want = pf.fine_spgemm_reference(*args, **kw)
                torch.cuda.synchronize()
                # Relative to max|C|: up to 17 products per slot, and the
                # tensor cores' f32 sums ("high", "default") round otherwise
                # than FFMA, so a small element of a long sum may differ by
                # more than 1e-5 of itself.
                err = rel_err(got, want)
                if not err <= TOL[prec]:
                    raise AssertionError(f"edges b={b} {prec} {layout} cap {cap}: "
                                         f"rel err {err:.3e} > {TOL[prec]}")
                if torch.count_nonzero(got[zero_slots]) != 0:
                    raise AssertionError(f"b={b} {prec} {layout}: a slot with no product")
                print(f"  edges b={b:2d} {prec:8s} {layout:9s} B row cap "
                      f"{'whole' if cap == mbr else 8:5}: kernel-vs-plain rel err="
                      f"{err:.3e} (k-chunk {kc}, C row 0 {row0} slots, products per slot "
                      f"0..{int(per_slot.max())})")


def rel_err(got, want) -> float:
    """max|got - want| / max|want| (0 for an all-zero pair)."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    diff = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    return diff / scale if scale else diff


def midpoint_tau(values):
    """A threshold halfway between the two middle sorted values, so no
    value lies near it."""
    v = sorted(float(x) for x in values)
    m = len(v) // 2
    return 0.5 * (v[m - 1] + v[m])


def small_rows():
    """Phase 3: the row-panel kernel vs its plain version at b=128."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import (
        rows_spgemm,
        rows_spgemm_reference,
    )
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

    b = 128
    A = random_pattern(6, 8, b, 0.35, seed=7, empty_rows=(1,))
    B = random_pattern(8, 5, b, 0.35, seed=8, empty_rows=(2,))
    pc, oc, mbr, mcr = plan_spgemm_ex(A, B)
    # Union slots in A's empty row 1 that no product reaches, then a tail.
    extra = torch.tensor([5, 8], dtype=torch.int32, device=DEVICE)
    plan = hbsm.make_plan(A, B, pc, accum_ids=extra, out_cap=oc + 2 + 3)
    out_ids, out_cap = plan.out_ids, oc + 5
    args = (A.ids, A.data, B.ids, B.data, out_ids, A.nb_rows, B.nb_rows,
            B.nb_cols, out_cap, mbr, mcr)
    no_product = (out_ids == 5) | (out_ids == 8) | (out_ids == 2**31 - 1)
    an2 = A.data.square().sum((1, 2))
    bn2 = B.data.square().sum((1, 2))
    pair_norms = an2[plan.a_idx[:pc].long()] * bn2[plan.b_idx[:pc].long()]
    acc = torch.randn((out_cap, b, b), device=DEVICE)
    cases = [(p, {}) for p in ("highest", "high", "default")] + [
        ("highest", dict(a_norms2=an2, b_norms2=bn2,
                         tau2=midpoint_tau(pair_norms.tolist()))),
        ("highest", dict(triu=True)),
        ("highest", dict(acc_data=acc)),
        ("bf16", {}),
    ]
    for prec, opts in cases:
        cargs = args
        if prec == "bf16":
            cargs = args[:1] + (A.data.bfloat16(),) + args[2:3] + (B.data.bfloat16(),) + args[4:]
            prec = "highest"
        got = rows_spgemm(*cargs, precision=prec, **opts)
        want = rows_spgemm_reference(*cargs, precision=prec, **opts)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        name = f"b=128 {prec} {sorted(opts) or ''}"
        if not err <= ROWS_TOL:
            raise AssertionError(f"rows {name}: rel err {err:.3e} > {ROWS_TOL}")
        sent = out_ids == 2**31 - 1
        if torch.count_nonzero(got[sent]):
            raise AssertionError(f"rows {name}: tail slots not zero")
        union = no_product & ~sent  # union slots that no product reaches
        start = acc[union] if "acc_data" in opts else torch.zeros_like(got[union])
        if not torch.equal(got[union], start):
            raise AssertionError(f"rows {name}: slots with no product changed")
        print(f"  rows {name:40s} kernel-vs-plain rel err={err:.3e}")


def small_norms():
    """Phase 3: both norm kernels vs their plain versions."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms as pn

    g = torch.Generator(device=DEVICE).manual_seed(3)
    data = torch.randn((37, 128, 128), device=DEVICE, generator=g)
    data[5] = 0
    data[20] = 0
    for x in (data, data.bfloat16()):
        n2_plain = pn.block_frob_squared_reference(x)
        tau = midpoint_tau(n2_plain.sqrt().tolist())
        n2 = pn.block_frob_squared(x)
        m2, keep = pn.norms_and_keep(x, tau)
        m2_plain, keep_plain = pn.norms_and_keep_reference(x, tau)
        torch.cuda.synchronize()
        for name, got in (("block_frob_squared", n2), ("norms_and_keep", m2)):
            if not torch.allclose(got, n2_plain, rtol=1e-5, atol=0):
                raise AssertionError(f"{name} {x.dtype}: differs from plain version")
        if not torch.equal(keep, keep_plain) or not torch.equal(m2_plain, n2_plain):
            raise AssertionError(f"norms_and_keep {x.dtype}: keep differs")
        if float(n2[5]) != 0.0 or float(n2[20]) != 0.0:
            raise AssertionError("zero blocks do not reduce to 0")
        err = float((n2 - n2_plain).abs().max() / n2_plain.max())
        print(f"  norms {str(x.dtype):15s} cap=37 rel err={err:.3e}, keep equal")


def small_stream():
    """Phase 3: the pair-stream kernel and the v1 chunked call vs their
    plain versions."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_stream as ps
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm

    g = torch.Generator(device=DEVICE).manual_seed(5)
    for b in (128, 256):
        A = random_pattern(5, 4, b, 0.5, seed=b, empty_rows=(2,))
        B = random_pattern(4, 6, b, 0.5, seed=b + 1)
        pc, oc = plan_spgemm(A, B)
        out_cap = oc + 2  # two slots that no pair reaches
        a_idx, b_idx, seg = pair_stream(A, B, pc + 5, out_cap)  # five padding pairs
        cin = torch.randn((out_cap, b, b), device=DEVICE, generator=g)
        f32, bf16 = (A.data, B.data), (A.data.bfloat16(), B.data.bfloat16())
        cases = [(p, f32, None) for p in ("highest", "high", "default")] + [
            ("bf16", bf16, None), ("highest", f32, cin)]
        for prec, (ad, bd), c in cases:
            tier = "highest" if prec == "bf16" else prec
            args = (ad, bd, a_idx, b_idx, seg, out_cap)
            got = ps.gather_gemm_accumulate_stream(*args, precision=tier, cin=c)
            want = ps.gather_gemm_accumulate_stream_reference(*args, precision=tier, cin=c)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            name = f"b={b} {prec}{' cin' if c is not None else ''} ({pc} pairs)"
            if not err <= ROWS_TOL:
                raise AssertionError(f"stream {name}: rel err {err:.3e} > {ROWS_TOL}")
            start = c[oc:] if c is not None else torch.zeros_like(got[oc:])
            if not torch.equal(got[oc:], start):
                raise AssertionError(f"stream {name}: slots that no pair reaches changed")
            print(f"  stream {name:34s} kernel-vs-plain rel err={err:.3e}")
        none = torch.zeros(0, dtype=torch.int32, device=DEVICE)
        empty = ps.gather_gemm_accumulate_stream(A.data, B.data, none, none, none, out_cap)
        kept = ps.gather_gemm_accumulate_stream(A.data, B.data, none, none, none, out_cap, cin=cin)
        torch.cuda.synchronize()
        if torch.count_nonzero(empty) or not torch.equal(kept, cin):
            raise AssertionError(f"stream b={b}: an empty pair list changed the slots")
        print(f"  stream b={b} empty pair list: zeros, or the carry-in as it is")
    # The v1 call chunked at 64 pairs against one chunk: the carry-in makes
    # the chunked sum the same sum.
    A = random_pattern(8, 8, 128, 0.6, seed=31)
    pc, oc = plan_spgemm(A, A)
    args = (A.data, A.data, *pair_stream(A, A, pc + 5, oc), oc)
    chunked = pallas_gemm.gather_gemm_accumulate(*args, chunk=64)
    single = pallas_gemm.gather_gemm_accumulate(*args, chunk=pc + 5)
    want = pallas_gemm.gather_gemm_accumulate_reference(*args)
    torch.cuda.synchronize()
    err = rel_err(chunked, want)
    if pc <= 128 or not torch.equal(chunked, single) or not err <= ROWS_TOL:
        raise AssertionError(f"gather_gemm_accumulate chunked: {pc} pairs, rel err {err:.3e}")
    print(f"  gather_gemm_accumulate: {pc} pairs in {-(-(pc + 5) // 64)} chunks of 64 "
          f"== one chunk, bitwise; kernel-vs-plain rel err={err:.3e}")


def explicit_pattern(rows, nbr, nbc, b, seed):
    """A BlockMatrix whose block row i holds the block columns rows[i]
    (N(0,1) blocks from a numpy seed)."""
    ids = np.array(sorted(i * nbc + k for i, cols in enumerate(rows) for k in cols),
                   dtype=np.int64)
    return block_matrix(ids, nbr, nbc, b, np.random.default_rng(seed))


# Products per slot at the tensor-core engine's ring edges (gemm_tile.cuh
# kStages = 3): none, one, as many as the ring has stages, one more, and
# more than twice as many.
RING_PRODUCTS = (0, 1, 3, 4, 7)


def small_ring_edges():
    """Phase 3: the two tensor-core kernels at their ring's edges: slots
    with RING_PRODUCTS products, an A row of more than 256 entries (two
    passes of the hit search), SpAMM skipping every product of a slot,
    triu with the aligned accumulator, and the stream at b=256 with a
    carry-in."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_stream as ps
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import (
        rows_spgemm,
        rows_spgemm_reference,
    )
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

    b = 128

    def rows_case(name, A, B, extra=(), precisions=("highest", "high", "default", "bf16"),
                  **opts):
        pc, oc, mbr, mcr = plan_spgemm_ex(A, B)
        ext = torch.tensor(extra, dtype=torch.int32, device=DEVICE)
        plan = hbsm.make_plan(A, B, pc, accum_ids=ext, out_cap=oc + len(extra) + 2)
        out_cap = oc + len(extra) + 2
        counts = torch.bincount(plan.seg[:pc].long(), minlength=out_cap)[:out_cap]
        if "acc_data" in opts:
            opts["acc_data"] = torch.randn((out_cap, b, b), device=DEVICE)
        for prec in precisions:
            ad, bd, tier = A.data, B.data, prec
            if prec == "bf16":
                ad, bd, tier = ad.bfloat16(), bd.bfloat16(), "highest"
            args = (A.ids, ad, B.ids, bd, plan.out_ids, A.nb_rows, B.nb_rows, B.nb_cols,
                    out_cap, mbr, mcr)
            got = rows_spgemm(*args, precision=tier, **opts)
            want = rows_spgemm_reference(*args, precision=tier, **opts)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            if not err <= ROWS_TOL:
                raise AssertionError(f"rows edge {name} {prec}: rel err {err:.3e} > {ROWS_TOL}")
            print(f"  rows edge {name:34s} {prec:8s} kernel-vs-plain rel err={err:.3e}")
        return plan, counts, got

    # Slot (i, j) has RING_PRODUCTS[i] products for every j; the row with
    # none holds union slots only.
    rows = [list(range(n)) for n in RING_PRODUCTS]
    A = explicit_pattern(rows, len(rows), 8, b, seed=41)
    B = explicit_pattern([range(3)] * 8, 8, 3, b, seed=42)
    _, counts, _ = rows_case("products per slot", A, B, extra=(0, 2))
    want = sorted(set(RING_PRODUCTS))
    if sorted(set(counts.tolist())) != want:
        raise AssertionError(f"rows edge: products per slot {counts.tolist()}, want {want}")
    # An A row of 300 entries: hits in both 256-entry passes.
    A = explicit_pattern([range(300), [7, 299]], 2, 300, b, seed=43)
    B = explicit_pattern([[0, 1] if k in (3, 7, 100, 255, 256, 260, 299) else []
                          for k in range(300)], 300, 2, b, seed=44)
    rows_case("A row of 300 entries", A, B, precisions=("highest", "bf16"))
    # SpAMM skipping every product of row 1's slots; triu with acc_data.
    A = explicit_pattern([range(4), range(5), range(3)], 3, 8, b, seed=45)
    B = explicit_pattern([range(3)] * 8, 8, 3, b, seed=46)
    an2 = A.data.square().sum((1, 2))
    an2[(A.ids // 8 == 1) & (A.ids != hbsm.SENTINEL)] = 0.0
    bn2 = B.data.square().sum((1, 2))
    plan, _, got = rows_case("SpAMM skips all of row 1", A, B, precisions=("highest",),
                             a_norms2=an2, b_norms2=bn2, tau2=1e-30)
    row1 = (plan.out_ids // 3 == 1) & (plan.out_ids != hbsm.SENTINEL)
    if torch.count_nonzero(got[row1]) or not bool(row1.any()):
        raise AssertionError("rows edge: a slot whose products are all skipped is not zero")
    rows_case("triu + acc_data", A, B, precisions=("highest", "default"), triu=True,
              acc_data=True)

    # The stream kernel: explicit pair lists with RING_PRODUCTS pairs per
    # slot, at b=128 and at b=256 with a carry-in.
    g = torch.Generator(device=DEVICE).manual_seed(47)
    rng = np.random.default_rng(48)
    for b, use_cin in ((128, False), (256, True)):
        cap = 9
        ad = torch.randn((cap, b, b), device=DEVICE, generator=g)
        bd = torch.randn((cap, b, b), device=DEVICE, generator=g)
        seg = np.repeat(np.arange(len(RING_PRODUCTS)), RING_PRODUCTS).astype(np.int32)
        out_cap = len(RING_PRODUCTS)
        a_idx, b_idx, seg = (torch.from_numpy(x).to(DEVICE) for x in (
            rng.integers(0, cap, seg.size).astype(np.int32),
            rng.integers(0, cap, seg.size).astype(np.int32), seg))
        cin = torch.randn((out_cap, b, b), device=DEVICE, generator=g) if use_cin else None
        for prec in ("highest", "default", "bf16"):
            x, y, tier = (ad, bd, prec) if prec != "bf16" else (ad.bfloat16(), bd.bfloat16(),
                                                                 "highest")
            args = (x, y, a_idx, b_idx, seg, out_cap)
            got = ps.gather_gemm_accumulate_stream(*args, precision=tier, cin=cin)
            want = ps.gather_gemm_accumulate_stream_reference(*args, precision=tier, cin=cin)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            if not err <= ROWS_TOL:
                raise AssertionError(f"stream edge b={b} {prec}: rel err {err:.3e}")
            empty = cin[0] if use_cin else torch.zeros_like(got[0])
            if not torch.equal(got[0], empty):
                raise AssertionError(f"stream edge b={b} {prec}: the slot with no pair changed")
            print(f"  stream edge b={b} {prec:8s}{' cin' if use_cin else '    '} pairs per slot "
                  f"{RING_PRODUCTS} kernel-vs-plain rel err={err:.3e}")


def exact_group_caps(A, B, out_ids, g):
    """(g, a_grp_max, slab_max, c_grp_max): the exact per-group maxima of
    this structure at `g` block rows per group."""
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_groups as pg

    t = pg.group_tables(A.ids, B.ids, out_ids, A.nb_rows, B.nb_rows, B.nb_cols, g)

    def widest(start):
        return int((start[1:] - start[:-1]).max())

    return (g, widest(t.grp_a_start), int(t.slab_cnt.max()), widest(t.grp_c_start))


def small_groups():
    """Phase 3: the row-group kernel vs its plain version, and spgemm on it
    with a fused accumulate and the group check."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_groups as pg
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm

    for b in (128, 256):
        sq = band_pattern(11, 11, 1, b, seed=b)
        cases = (
            (sq, sq, "11x11 G=4 (last group 3 rows)"),
            (band_pattern(7, 5, 1, b, seed=b + 1), band_pattern(5, 9, 2, b, seed=b + 2),
             "7x5 @ 5x9 G=4"),
        )
        for A, B, tag in cases:
            pc, oc = plan_spgemm(A, B)
            # Union slots (0, last column) and (last row, 0), which no
            # product reaches, then a tail of three.
            off = [B.nb_cols - 1, (A.nb_rows - 1) * B.nb_cols]
            extra = torch.tensor(off, dtype=torch.int32, device=DEVICE)
            out_cap = oc + 5
            out_ids = hbsm.make_plan(A, B, pc, accum_ids=extra, out_cap=out_cap).out_ids
            args = (A.ids, A.data, B.ids, B.data, out_ids, A.nb_rows, B.nb_rows,
                    B.nb_cols, out_cap, *exact_group_caps(A, B, out_ids, 4))
            no_product = (out_ids == off[0]) | (out_ids == off[1]) | (out_ids == hbsm.SENTINEL)
            for prec in ("highest", "high", "default", "bf16"):
                cargs = args
                if prec == "bf16":
                    cargs = (args[0], A.data.bfloat16(), args[2], B.data.bfloat16()) + args[4:]
                tier = "highest" if prec == "bf16" else prec
                got = pg.groups_spgemm(*cargs, precision=tier)
                want = pg.groups_spgemm_reference(*cargs, precision=tier)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                name = f"b={b} {tag} {prec}"
                if not err <= ROWS_TOL:
                    raise AssertionError(f"groups {name}: rel err {err:.3e} > {ROWS_TOL}")
                if torch.count_nonzero(got[no_product]):
                    raise AssertionError(f"groups {name}: slots with no product not zero")
                print(f"  groups {name:44s} kernel-vs-plain rel err={err:.3e}")
    # spgemm on the group kernel with a fused accumulate whose blocks lie
    # off the product's support, against the torch path.
    A = band_pattern(11, 11, 1, 128, seed=9)
    D = block_matrix([10, 110], 11, 11, 128, np.random.default_rng(10))
    gplan = hbsm.plan_groups(A, A)
    pc, oc = plan_spgemm(A, A)
    kw = dict(accum=D, beta=0.5)
    C, info = hbsm.spgemm(A, A, pc, oc + 2, backend="groups", group_caps=gplan.caps, **kw)
    Cx, _ = hbsm.spgemm(A, A, pc, oc + 2, backend="xla", **kw)
    err = rel_err(C.data, Cx.data)
    slot = int(torch.searchsorted(C.ids, torch.tensor(10, dtype=torch.int32, device=DEVICE)))
    if not torch.equal(C.ids, Cx.ids) or not err <= ROWS_TOL or bool(info.row_overflow):
        raise AssertionError(f"spgemm groups with accum: rel err {err:.3e} vs the torch path")
    if not torch.equal(C.data[slot], 0.5 * D.data[0]):
        raise AssertionError("spgemm groups: a union slot with no product is not beta*D")
    # An undersized slab cap gives wrong blocks and must be flagged.
    g_rows, a_gm, s_gm, c_gm = gplan.caps
    _, bad = hbsm.spgemm(A, A, pc, oc, backend="groups", group_caps=(g_rows, a_gm, 8, c_gm))
    if s_gm <= 8 or not bool(bad.row_overflow):
        raise AssertionError(f"slab cap 8 < {s_gm} was not flagged")
    print(f"  spgemm groups {gplan.caps} + 0.5*D vs torch path rel err={err:.3e}; "
          f"union slot = beta*D exactly; slab cap 8 < {s_gm} flagged")


def graft_step():
    """Phase 6: the port's entry step (entry.py::entry, the graft entry's
    input) vs its f64 product."""
    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.entry import entry

    fn, (x,) = entry()
    n = x.n_rows
    y, st = fn(x)
    flags = [bool(getattr(st, f)) for f in (
        "pair_overflow", "out_overflow", "repack_overflow", "plan_mismatch")]
    if any(flags):
        raise AssertionError(f"graft step flags {flags}")
    dx = hbsm.to_dense(x).double()
    sq = float(st.trace) > n / 2
    want = dx @ dx if sq else 2 * dx - dx @ dx
    err = rel_err(hbsm.to_dense(y).double(), want)
    print(f"[graft] entry(): sp2_step 1024^2 b=128 ({'X^2' if sq else '2X - X^2'}): "
          f"{int(st.n_block_pairs)} pairs, {int(st.nnz_blocks)} blocks kept, "
          f"vs f64 rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"graft step rel err {err:.3e} > 1e-5")


def b3_input():
    """bench.py's B3 input (bench_truncation_pipeline), on the card."""
    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import (
        banded_block_matrix,
    )

    n, b = 4096, 128
    A = banded_block_matrix(n, 256, b)
    A = hbsm.add(A, hbsm.transpose(A), alpha=0.5, beta=0.5)
    A = hbsm.scale(A, 1.0 / float(np.sqrt(float(hbsm.frob_squared(A)))))
    return hbsm.add(A, hbsm.eye(n, b), beta=0.5, cap=A.cap + n // b)


def wrappers():
    """Kernel name -> the wrapper that counts its launches."""
    from hierarchical_block_sparse_lib_tpu_torch.kernels import (
        micro_fine,
        pallas_gemm,
        pallas_gemm_fine,
        pallas_gemm_groups,
        pallas_gemm_rows,
        pallas_gemm_stream,
        pallas_norms,
    )

    return {
        **{name: getattr(micro_fine, name) for name in MICRO_KERNELS},
        "fine_spgemm": pallas_gemm_fine.fine_spgemm,
        "rows_spgemm": pallas_gemm_rows.rows_spgemm,
        "block_frob_squared": pallas_norms.block_frob_squared,
        "norms_and_keep": pallas_norms.norms_and_keep,
        "gather_gemm_accumulate_stream": pallas_gemm_stream.gather_gemm_accumulate_stream,
        "groups_spgemm": pallas_gemm_groups.groups_spgemm,
        "gather_gemm_accumulate": pallas_gemm.gather_gemm_accumulate,
    }


def counts(names=B3_KERNELS):
    return {name: wrappers()[name].launches for name in names}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def launched(want: dict, path: str) -> dict:
    """Every count as the path must leave it (zero for kernels not named),
    or raise."""
    got = {k: v for k, v in counts(KERNELS).items() if v}
    if got != want:
        raise AssertionError(f"{path} launches {got}, expected {want}")
    return got


def b3_path():
    """Phase 7: the B3 purification path at its configured size."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm

    n, steps, tau = 4096, 5, 1e-6
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    A = b3_input()
    prof = hbsm.profile_purify(A, steps, tau, target_trace=n / 2)
    got = {k: getattr(prof, k) for k in B3_PROFILE}
    print(f"[B3] input {int(A.nnz)} blocks at cap {A.cap}; profile {got}")
    if got != B3_PROFILE:
        raise AssertionError(f"B3 profile differs from the JAX package's {B3_PROFILE}")
    kw = dict(target_trace=n / 2, **prof.kwargs())
    c0 = counts()
    xu, su = hbsm.purify_scan(A, steps, tau, **kw)
    c1 = counts()
    plans = hbsm.plan_purify(A, steps, tau, prof, target_trace=n / 2)
    c2 = counts()
    with no_host_sync():
        xp, sp = hbsm.purify_scan(A, steps, tau, plans=plans, **kw)
    c3 = counts()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = counts()
    print(f"[B3] path (input, profile, scan, plan, planned scan) {path_s:.2f} s "
          f"(first calls); launches {launches}")
    for name, before, after in (("unplanned", c0, c1), ("planned", c2, c3)):
        per = {k: after[k] - before[k] for k in ("rows_spgemm", "norms_and_keep")}
        if per != {"rows_spgemm": steps, "norms_and_keep": steps}:
            raise AssertionError(f"{name} scan launches {per}, expected {steps} each")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the B3 path never launched: {launches}")
    for name, st in (("unplanned", su), ("planned", sp)):
        bad = {f: bool(getattr(st, f).any()) for f in (
            "pair_overflow", "out_overflow", "repack_overflow", "plan_mismatch")}
        if any(bad.values()):
            raise AssertionError(f"B3 {name} scan flags {bad}")
    if not (torch.equal(xp.ids, xu.ids) and torch.equal(xp.data, xu.data)):
        raise AssertionError("B3 planned and unplanned scans are not bitwise equal")
    print(f"[B3] planned == unplanned bitwise; planned scan ran with no host sync; "
          f"pairs/step {su.n_block_pairs.tolist()}, kept {su.nnz_blocks.tolist()}")
    a64 = A.with_data(A.data.double())
    x64, s64 = hbsm.purify_scan(a64, steps, tau, backend="xla", **kw)
    if not torch.equal(x64.ids, xu.ids):
        raise AssertionError("B3 f32 and f64 iterates keep different blocks")
    err = rel_err(xu.data.double(), x64.data)
    print(f"[B3] iterate vs the port's float64 path: ids equal, rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"B3 rel err {err:.3e} > 1e-5")
    return A, prof, plans, launches, (xu, su)


@contextlib.contextmanager
def no_host_sync():
    """Raise on any operation that makes the host wait for the card
    (PyTorch's sync debug mode, which warns that it may miss some)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def plain_kernels():
    """Route the B3 path's kernel calls to their plain versions (timing
    only: the plain path of the same scan)."""
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as rows
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms as pn

    saved = (rows.rows_spgemm, pn.norms_and_keep, pn.block_frob_squared)
    rows.rows_spgemm = rows.rows_spgemm_reference
    pn.norms_and_keep = pn.norms_and_keep_reference
    pn.block_frob_squared = pn.block_frob_squared_reference
    try:
        yield
    finally:
        rows.rows_spgemm, pn.norms_and_keep, pn.block_frob_squared = saved


def b3_kernels_and_times(A, prof, plans, card):
    """Phase 8: kernels vs plain at B3's step-2 shapes, and times."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as rows
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms as pn

    n, steps, tau = 4096, 5, 1e-6
    kw = dict(target_trace=n / 2, **prof.kwargs())
    x2, _ = hbsm.purify_scan(A, 2, tau, **kw)  # the step-2 input
    p2 = plans.step(2)
    rc = prof.row_caps
    rargs = (x2.ids, x2.data, x2.ids, x2.data, p2.out_ids, x2.nb_rows,
             x2.nb_rows, x2.nb_cols, prof.out_cap, rc[0], rc[1])
    got = rows.rows_spgemm(*rargs)
    want = rows.rows_spgemm_reference(*rargs)
    pairs2 = int(p2.total)
    rows_err = float((got - want).abs().max())
    rel = rel_err(got, want)
    print(f"[B3] rows_spgemm at step 2 ({pairs2} pairs, out_cap {prof.out_cap}): "
          f"kernel vs plain max abs err {rows_err:.3e}, rel {rel:.3e}")
    if rel > ROWS_TOL:
        raise AssertionError(f"B3 rows_spgemm rel err {rel:.3e}")
    ydata = got  # the step's product blocks: norms_and_keep's input shape
    n2, keep = pn.norms_and_keep(ydata, tau)
    n2p, keepp = pn.norms_and_keep_reference(ydata, tau)
    f2 = pn.block_frob_squared(ydata)
    nk_err = float((n2 - n2p).abs().max())
    fb_err = float((f2 - n2p).abs().max())
    if not torch.allclose(n2, n2p, rtol=1e-5, atol=0) or not torch.allclose(f2, n2p, rtol=1e-5, atol=0):
        raise AssertionError("B3 norm kernels differ from the plain version")
    if not torch.equal(keep, keepp):
        raise AssertionError("B3 norms_and_keep keep mask differs from the plain version")
    print(f"[B3] norms at out_cap {prof.out_cap}: max abs err norms_and_keep "
          f"{nk_err:.3e}, block_frob_squared {fb_err:.3e}; keep equal")

    t = {}
    t["scan"] = alternate(
        lambda: hbsm.purify_scan(A, steps, tau, **kw), _plain(lambda: hbsm.purify_scan(A, steps, tau, **kw)))
    t["planned"] = alternate(
        lambda: hbsm.purify_scan(A, steps, tau, plans=plans, **kw),
        _plain(lambda: hbsm.purify_scan(A, steps, tau, plans=plans, **kw)))
    t["rows"] = alternate(lambda: rows.rows_spgemm(*rargs), lambda: rows.rows_spgemm_reference(*rargs))
    t["norms_and_keep"] = alternate(lambda: pn.norms_and_keep(ydata, tau),
                                    lambda: pn.norms_and_keep_reference(ydata, tau))
    t["block_frob_squared"] = alternate(lambda: pn.block_frob_squared(ydata),
                                        lambda: pn.block_frob_squared_reference(ydata))
    lib_ms, _ = cuda_time_ms(lambda: torch.einsum("cij,cij->c", ydata, ydata))
    print(f"[time] {card}: B3, CUDA events, median of 7 after 2 warm-up calls, "
          f"in turns plain, kernel, kernel, plain (kernel pair / plain pair)")
    for name, (k, p, four) in t.items():
        print(f"[time]   {name:20s} kernel {four[0]:.4f} / {four[1]:.4f} ms   "
              f"plain {four[2]:.4f} / {four[3]:.4f} ms")
    print(f"[time]   einsum('cij,cij->c') at out_cap {prof.out_cap}: {lib_ms:.4f} ms")
    nbytes_norms = ydata.numel() * ydata.element_size()
    cap = ydata.shape[0]

    # Products per slot at step 2 (the wave choice rests on them), then
    # rows_spgemm at each step's shape: the call beside its kernel's
    # device time per launch, and both bounds.
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import launch_config

    per_slot = torch.bincount(p2.seg[:pairs2].long(), minlength=prof.out_cap)[:prof.out_cap]
    q = torch.quantile(per_slot.double(), torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64,
                                                       device=per_slot.device)).tolist()
    cfg = launch_config(torch.float32, "highest")
    blocks = prof.out_cap * 2  # a block per 128 x 64 half of a slot
    resident = cfg["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[B3] products per slot at step 2 over {prof.out_cap} slots: min {int(per_slot.min())}, "
          f"p10 {q[0]:.0f}, median {q[1]:.0f}, p90 {q[2]:.0f}, max {int(per_slot.max())}, "
          f"mean {pairs2 / prof.out_cap:.2f}; {int((per_slot == 0).sum())} slots with none; "
          f"{blocks} blocks over {resident} resident = {blocks / resident:.2f} waves")
    rows_steps = {}
    for k in range(3):
        xk = hbsm.repack(A, prof.cap) if k == 0 else hbsm.purify_scan(A, k, tau, **kw)[0]
        pk = plans.step(k)
        kargs = (xk.ids, xk.data, xk.ids, xk.data, pk.out_ids, xk.nb_rows, xk.nb_rows,
                 xk.nb_cols, prof.out_cap, rc[0], rc[1])
        call = cuda_time_ms(lambda: rows.rows_spgemm(*kargs))[0]
        dev = device_profile(f"rows_spgemm at step {k}", lambda: rows.rows_spgemm(*kargs),
                             10, card, top=3)
        us = per_call_us(dev, 10, "rows_spgemm_kernel")
        pairs = int(pk.total)
        rows_steps[k] = tile_bounds(2 * 128**3 * pairs,
                                    stored_bytes(xk) + prof.out_cap * 128 * 128 * 4, us)
        b = rows_steps[k]
        print(f"[time]   rows_spgemm step {k} ({pairs} pairs): call {call:.4f} ms, kernel "
              f"{us:.1f} us per launch; bounds FP32 {b['bound_fp32_ms']:.4f} ms "
              f"({pct(b['share_fp32'])}), 3xTF32 {b['bound_route_ms']:.4f} ms "
              f"({pct(b['share_route'])})")
    per_step = [rows_steps[k]["device_ms"] for k in (0, 1, 2, 2, 2)]
    print(f"[time]   rows_spgemm per 5-step scan (steps 0, 1, 2, 2, 2): "
          + ("not measured" if None in per_step else f"{1e3 * sum(per_step):.1f} us")
          + " of device time")
    bmm_ms = bmm_yardstick(x2.data, x2.data, p2.a_idx[:pairs2], p2.b_idx[:pairs2])
    print(f"[time]   yardstick: torch.bmm over step 2's {pairs2} gathered pairs, TF32 off: "
          f"{bmm_ms:.4f} ms (the products alone, without their sum into slots)")
    entries = {
        "rows_spgemm": dict(max_abs_err=rows_err, ms=t["rows"][0], plain_ms=t["rows"][1],
                            bound=bound(2 * 128**3 * pairs2, stored_bytes(x2)
                                        + prof.out_cap * 128 * 128 * 4, "tf32x3"),
                            library_ms=None, **rows_steps[2]),
        "norms_and_keep": dict(
            max_abs_err=nk_err, ms=t["norms_and_keep"][0], plain_ms=t["norms_and_keep"][1],
            bound=bound(2 * ydata.numel(), nbytes_norms + cap * 5), library_ms=lib_ms),
        "block_frob_squared": dict(
            max_abs_err=fb_err, ms=t["block_frob_squared"][0],
            plain_ms=t["block_frob_squared"][1],
            bound=bound(2 * ydata.numel(), nbytes_norms + cap * 4), library_ms=lib_ms),
    }
    scans = {k: t[k] for k in ("scan", "planned")}
    for name in ("scan", "planned"):
        k, p, _ = t[name]
        print(f"[B3] purify_scan ({name}) per 5-step iteration: kernels {k:.3f} ms, "
              f"plain {p:.3f} ms")
    return entries, scans


def _plain(fn):
    def run():
        with plain_kernels():
            fn()
    return run


def acceptance_purification():
    """Phase 9: scripts/acceptance.py's B3 check on the port."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen

    n, b, nocc = 1024, 128, 256
    r, c, v = gen.banded_coo(n, 40, seed=3)
    H = hbsm.from_coo(r, c, v, n, block_size=b)
    dH = hbsm.to_dense(H).double()
    dH = (dH + dH.T) / 2
    H = hbsm.from_dense(dH.float(), block_size=b)
    w, V = torch.linalg.eigh(dH)
    lo, hi = float(w[0]), float(w[-1])
    X = hbsm.add(hbsm.eye(n, b, cap=H.cap + n // b), H,
                 alpha=hi / (hi - lo), beta=-1.0 / (hi - lo))
    nb = n // b
    Xf, st = hbsm.purify_scan(X, 40, tau=1e-7, pair_cap=nb**3, out_cap=nb * nb,
                              target_trace=nocc, row_caps=(nb, nb))
    if bool((st.pair_overflow | st.out_overflow | st.repack_overflow).any()):
        raise AssertionError("1024^2 purification overflowed")
    proj = V[:, :nocc] @ V[:, :nocc].T
    rel = float(torch.linalg.norm(hbsm.to_dense(Xf).double() - proj) / torch.linalg.norm(proj))
    print(f"[accept] purification 1024^2, 40 steps, tau=1e-7 -> spectral projector: "
          f"Frobenius rel err {rel:.3e}")
    if rel > 1e-4:
        raise AssertionError(f"purification rel err {rel:.3e} > 1e-4")


def device_profile(label, run, reps, card, unit="call", top=10):
    """torch.profiler over `reps` calls of run(): the CUDA-event window,
    the device's busy time and idle share, and device time by kernel, per
    call.  Returns {kernel: (device us, launches) recorded over the `reps`
    calls}, empty when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        stop.synchronize()
    window_us = start.elapsed_time(stop) * 1e3
    kernels = {}
    for e in p.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and e.cpu_time_total == 0:
            kernels[e.key] = (dev, e.count)
    busy = sum(t for t, _ in kernels.values())
    print(f"[profile] {card}: {reps} x {label}, window {window_us / reps:.1f} us "
          f"per {unit} (CUDA events)")
    if busy == 0:
        print("[profile] the profiler recorded no device time: not measured")
        return {}
    print(f"[profile]   device busy {busy / reps:.1f} us per {unit}, idle "
          f"{100 * (1 - busy / window_us):.1f}% of the window")
    for name, (t, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]   {100 * t / busy:5.1f}%  {t / reps:8.1f} us/{unit}  "
              f"{cnt / reps:5.1f} launches/{unit}  {name[:90]}")
    print(f"[profile]   {len(kernels)} distinct device functions, "
          f"{sum(c for _, c in kernels.values()) // reps} launches per {unit}")
    return kernels


def per_call_us(dev, reps, match=""):
    """Device us per call of the kernels of `dev` (device_profile's totals
    over `reps` calls) whose names hold `match`: each kernel's time per
    recorded launch times its launches per call.  The profiler can drop a
    launch's record (late in this script, one of ten launches of a
    one-kernel call), which a total over `reps` would count as no time."""
    return sum(t / n * round(n / reps) for k, (t, n) in dev.items() if match in k and n)


def tile_bounds(flops, nbytes, device_us, kind="tf32x3"):
    """A tensor-core kernel's two bounds, FP32 FFMA and the tier's
    tensor-core route (`kind`, utils/profiling.PEAK_OPS), each with the
    kernel's share of it (bound / device time per launch)."""
    fp32, route = bound(flops, nbytes, "fp32"), bound(flops, nbytes, kind)
    dev_ms = device_us / 1e3 if device_us else None  # None: the profiler saw no launch
    return dict(bound_fp32_ms=fp32[0], bound_route=kind, bound_route_ms=route[0],
                route_bound_by=route[1], device_ms=dev_ms,
                share_fp32=fp32[0] / dev_ms if dev_ms else None,
                share_route=route[0] / dev_ms if dev_ms else None)


def stored_bytes(M) -> int:
    """Bytes of M's stored blocks (its nnz, not its capacity): what a
    kernel that reads each stored block once must move."""
    return int(M.nnz) * M.block_size * M.block_size * M.data.element_size()


def pct(share):
    """A share as a percentage, or "not measured"."""
    return "not measured" if share is None else f"{100 * share:.1f}%"


def bmm_yardstick(a_data, b_data, a_idx, b_idx):
    """ms of one torch.bmm over the gathered pairs, TF32 off (the gather is
    not timed): a yardstick of the dense work, not the same function."""
    import torch

    ga, gb = a_data[a_idx.long()], b_data[b_idx.long()]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_time_ms(lambda: torch.bmm(ga, gb))[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def profile_planned_b3(A, prof, plans, card):
    """Phase 10: torch.profiler over 10 planned B3 scans: device time by
    kernel and the device's idle share of the window."""
    import hierarchical_block_sparse_lib_tpu_torch as hbsm

    n, steps, tau = 4096, 5, 1e-6
    kw = dict(target_trace=n / 2, plans=plans, **prof.kwargs())
    device_profile("planned B3 scan", lambda: hbsm.purify_scan(A, steps, tau, **kw), 10,
                   card, unit="scan")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    print(f"[profile]   after: {smi.stdout.strip()}")


def purify_b3(A, prof, scan):
    """Phase 11: B3's input through `purify`, which passes no row caps, so
    "auto" takes the pair-stream kernel; held against phase 7's unplanned
    scan on the row-panel kernel."""
    import dataclasses

    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import resolve_backend

    n, steps, tau = A.n_rows, 5, 1e-6
    xs, ss = scan
    backend = resolve_backend(A.block_size, A.dtype, A.nb_cols, prof.pair_cap)
    torch.cuda.synchronize()
    reset_counts()
    x, stats = hbsm.purify(A, steps, tau, pair_cap=prof.pair_cap, out_cap=prof.out_cap,
                           target_trace=n / 2, cap=prof.cap)
    torch.cuda.synchronize()
    got = launched({"gather_gemm_accumulate_stream": steps, "norms_and_keep": steps},
                   "purify on B3")
    if backend != "pallas":
        raise AssertionError(f"purify at b=128 resolves to {backend!r}")
    for k, st in enumerate(stats):
        for f in dataclasses.fields(st):
            g, w = getattr(st, f.name), getattr(ss, f.name)[k]
            if f.name == "trace":  # the same sum; 1e-6 relative allows another order
                same = abs(float(g) - float(w)) <= 1e-6 * abs(float(w))
            else:
                same = bool(g == w)
            if not same:
                raise AssertionError(f"purify step {k} {f.name}: {g} vs the scan's {w}")
    if not torch.equal(x.ids, xs.ids):
        raise AssertionError("purify and the rows-backend scan keep different blocks")
    err = rel_err(x.data, xs.data)
    traces_equal = all(float(st.trace) == float(ss.trace[k]) for k, st in enumerate(stats))
    print(f"[purify] B3 input, {steps} steps on {backend!r}: launches {got}; stats equal "
          f"to the rows-backend scan (traces bitwise: {traces_equal}); ids equal, iterate "
          f"rel err {err:.3e} (bitwise: {torch.equal(x.data, xs.data)})")
    if err > 1e-5:
        raise AssertionError(f"purify iterate rel err {err:.3e} > 1e-5")
    return got["gather_gemm_accumulate_stream"]


def b1_input():
    """bench.py's B1 (bench.py:700-721): banded 4096^2, bandwidth 64,
    assembled at leaf 16 and coarsened x8 with leaf tracking.  Returns
    (A16, A, occ)."""
    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen

    n, bw = 4096, 64
    r, c, v = gen.banded_coo(n, bw, seed=0)
    a16 = hbsm.from_coo(r, c, v, n, block_size=16)
    a, occ = hbsm.coarsen(a16, 8, cap=hbsm.plan_coarsen(a16, 8), track_leaves=True)
    return a16, a, occ


def b1_path(card):
    """Phase 12: the configured B1 on the row-group kernel."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_groups as pg
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
        plan_spgemm,
        plan_spgemm_ex,
        resolve_backend,
    )

    torch.cuda.synchronize()
    reset_counts()
    a16, A, occ = b1_input()
    fine_pairs, _ = plan_spgemm(a16, a16)
    gplan = hbsm.plan_groups(A, A)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    caps = dict(row_caps=(mbr, mcr), group_caps=gplan.caps)
    backend = resolve_backend(A.block_size, A.dtype, A.nb_cols, pc, **caps)
    plan_fields = dict(caps=gplan.caps, slab_blocks=gplan.slab_blocks, pairs=gplan.pairs)
    print(f"[B1] {int(A.nnz)} blocks of 128 (from {int(a16.nnz)} of 16); {gplan}, "
          f"reuse {gplan.reuse:.2f}; pairs {pc}, out {oc}, leaf-16 pairs {fine_pairs}; "
          f"auto -> {backend!r}")
    if plan_fields != B1_PLAN or (pc, oc, fine_pairs) != B1_COUNTS or backend != "groups":
        raise AssertionError(f"B1 plans differ from the JAX package's {B1_PLAN}, {B1_COUNTS}")
    leaf = dict(a_leaf_occ=occ, b_leaf_occ=occ)
    Cm, im = hbsm.matmul(A, A)
    Cu, iu = hbsm.spgemm(A, A, pc, oc, **caps, **leaf)
    plan = hbsm.make_plan(A, A, pc)
    with no_host_sync():
        Cp, ip = hbsm.spgemm(A, A, pc, oc, plan=plan, **caps, **leaf)
    torch.cuda.synchronize()
    got = launched({"groups_spgemm": 3}, "B1 path (matmul, spgemm, planned spgemm)")
    for name, C, info, want_leaf in (("matmul", Cm, im, -1), ("spgemm", Cu, iu, fine_pairs),
                                     ("planned spgemm", Cp, ip, fine_pairs)):
        n = (int(info.n_block_pairs), int(info.n_out_blocks), int(info.n_leaf_multiplies))
        flags = [bool(getattr(info, f)) for f in (
            "pair_overflow", "out_overflow", "row_overflow", "plan_mismatch")]
        if n != (pc, oc, want_leaf) or any(flags):
            raise AssertionError(f"B1 {name}: counters {n}, flags {flags}")
        if not (torch.equal(C.ids, Cu.ids) and torch.equal(C.data, Cu.data)):
            raise AssertionError(f"B1 {name} differs from the unplanned spgemm")
    d16 = hbsm.to_dense(a16).double()
    err = rel_err(hbsm.to_dense(Cu).double(), d16 @ d16)
    del d16
    print(f"[B1] launches {got}; matmul, spgemm and planned spgemm (no host sync) "
          f"bitwise equal with counters {pc}/{oc}/{fine_pairs} (leaf) and no flag; vs "
          f"f64 dense oracle rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"B1 rel err {err:.3e} > 1e-5")

    gargs = (A.ids, A.data, A.ids, A.data, Cu.ids, A.nb_rows, A.nb_rows, A.nb_cols, oc,
             *gplan.caps)
    gk = pg.groups_spgemm(*gargs)
    gp = pg.groups_spgemm_reference(*gargs)
    torch.cuda.synchronize()
    abs_err, rel = float((gk - gp).abs().max()), rel_err(gk, gp)
    if rel > ROWS_TOL:
        raise AssertionError(f"B1 groups_spgemm vs plain rel err {rel:.3e}")
    print(f"[B1] groups_spgemm vs plain: max abs err {abs_err:.3e}, rel {rel:.3e}")
    k_ms, p_ms, four = alternate(lambda: pg.groups_spgemm(*gargs),
                                 lambda: pg.groups_spgemm_reference(*gargs))
    flops, nbytes = 2 * 128**3 * pc, A.data.numel() * 4 + oc * 128 * 128 * 4
    gdev = device_profile("groups_spgemm at B1", lambda: pg.groups_spgemm(*gargs), 10, card,
                          top=3)
    g_bounds = tile_bounds(flops, nbytes, per_call_us(gdev, 10, "groups_kernel"))
    backends = ("groups", "rows", "pallas")
    for be in backends[1:]:
        # One engine, one tile split and one product order: the same bits.
        C, _ = hbsm.spgemm(A, A, pc, oc, plan=plan, backend=be, **caps)
        if not (torch.equal(C.ids, Cu.ids) and torch.equal(C.data, Cu.data)):
            raise AssertionError(f"B1 planned spgemm on {be!r} is not bitwise equal to "
                                 f"'groups': rel diff {rel_err(C.data, Cu.data):.3e}")
        print(f"[B1] planned spgemm on {be!r} == 'groups', bitwise")
    times = in_turns({be: (lambda be=be: hbsm.spgemm(A, A, pc, oc, plan=plan, backend=be, **caps))
                      for be in backends})
    print(f"[time] {card}: B1, CUDA events, median of 7 after 2 warm-up calls")
    print(f"[time]   groups_spgemm kernel {four[0]:.4f} / {four[1]:.4f} ms   "
          f"plain {four[2]:.4f} / {four[3]:.4f} ms; kernel "
          f"{1e3 * (g_bounds['device_ms'] or 0):.1f} us per launch: bounds FP32 "
          f"{g_bounds['bound_fp32_ms']:.4f} ms ({pct(g_bounds['share_fp32'])}), 3xTF32 "
          f"{g_bounds['bound_route_ms']:.4f} ms ({pct(g_bounds['share_route'])})")
    for be, (t1, t2) in times.items():
        print(f"[time]   planned spgemm on {be:7s} {t1:.4f} / {t2:.4f} ms "
              f"(in order groups, rows, pallas, then reversed)")
    for be in backends:
        device_profile(f"planned B1 spgemm on {be!r}",
                       lambda be=be: hbsm.spgemm(A, A, pc, oc, plan=plan, backend=be, **caps),
                       20, card, top=4)
    entry = dict(max_abs_err=abs_err, ms=k_ms, plain_ms=p_ms, library_ms=None,
                 bound=bound(flops, nbytes, "tf32x3"), **g_bounds)
    # Phase 15's band tier is held against this product and timed beside
    # the planned product on "pallas".
    b1 = dict(a16=a16, C=Cu, fine_pairs=fine_pairs,
              pallas=lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, backend="pallas", **caps))
    return entry, got["groups_spgemm"], b1


def b2_tile128(card):
    """Phase 13: B2-tile128 without row caps, on the pair-stream kernel,
    and the v1 call on the same pairs."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import first_of_run
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_stream as ps
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex, resolve_backend
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix

    torch.cuda.synchronize()
    reset_counts()
    A = random_block_matrix(16384, 128, 0.05, seed=2)
    pc, oc, _, _ = plan_spgemm_ex(A, A)
    backend = resolve_backend(A.block_size, A.dtype, A.nb_cols, pc)
    C, info = hbsm.spgemm(A, A, pc, oc)
    C2, _ = hbsm.spgemm(A, A, pc, oc)
    plan = hbsm.make_plan(A, A, pc)
    with no_host_sync():
        Cp, ip = hbsm.spgemm(A, A, pc, oc, plan=plan)
    torch.cuda.synchronize()
    got = launched({"gather_gemm_accumulate_stream": 3}, "B2-tile128 path")
    print(f"[B2t] 16384^2 b=128 5% seed 2: {int(A.nnz)} blocks, pairs {pc}, out {oc}, "
          f"no row caps: auto -> {backend!r}; launches {got}")
    if (pc, oc) != B2T_COUNTS or backend != "pallas":
        raise AssertionError(f"B2-tile128 plan ({pc}, {oc}) or backend {backend!r}")
    for name, i in (("spgemm", info), ("planned spgemm", ip)):
        n = (int(i.n_block_pairs), int(i.n_out_blocks))
        flags = [bool(getattr(i, f)) for f in (
            "pair_overflow", "out_overflow", "row_overflow", "plan_mismatch")]
        if n != (pc, oc) or any(flags):
            raise AssertionError(f"B2-tile128 {name}: counters {n}, flags {flags}")
    for name, R in (("repeated", C2), ("planned", Cp)):
        if not (torch.equal(R.ids, C.ids) and torch.equal(R.data, C.data)):
            raise AssertionError(f"B2-tile128 {name} spgemm is not bitwise equal")
    del C2, Cp
    A64 = A.with_data(A.data.double())
    C64, _ = hbsm.spgemm(A64, A64, pc, oc)
    if not torch.equal(C64.ids, C.ids):
        raise AssertionError("B2-tile128 f32 and f64 products have different ids")
    err = rel_err(C.data.double(), C64.data)
    del A64, C64
    print(f"[B2t] counters as planned, no flag; repeated and planned (no host sync) calls "
          f"bitwise equal; "
          f"vs the float64 path: ids equal, rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"B2-tile128 rel err {err:.3e} > 1e-5")

    # The v1 entry point on the same pairs, in one chunk of PAIR_CHUNK.
    seg = torch.where(plan.c_id != hbsm.SENTINEL,
                      torch.cumsum(first_of_run(plan.c_id), 0) - 1, oc).to(torch.int32)
    sargs = (A.data, A.data, plan.a_idx, plan.b_idx, seg, oc)
    torch.cuda.synchronize()
    reset_counts()
    V = pallas_gemm.gather_gemm_accumulate(*sargs)
    torch.cuda.synchronize()
    v1 = launched({"gather_gemm_accumulate": 1, "gather_gemm_accumulate_stream": 1},
                  "gather_gemm_accumulate on B2-tile128")
    if not torch.equal(V, C.data):
        raise AssertionError("gather_gemm_accumulate differs from spgemm's stream product")
    sk = ps.gather_gemm_accumulate_stream(*sargs)
    sp = ps.gather_gemm_accumulate_stream_reference(*sargs)
    vp = pallas_gemm.gather_gemm_accumulate_reference(*sargs)
    torch.cuda.synchronize()
    abs_err, rel = float((sk - sp).abs().max()), rel_err(sk, sp)
    v1_err, v1_rel = float((V - vp).abs().max()), rel_err(V, vp)
    del V, sk, sp, vp
    print(f"[B2t] gather_gemm_accumulate == spgemm's product, bitwise (launches {v1}); "
          f"vs plain: stream kernel max abs err {abs_err:.3e} (rel {rel:.3e}), "
          f"v1 call {v1_err:.3e} (rel {v1_rel:.3e})")
    if max(rel, v1_rel) > ROWS_TOL:
        raise AssertionError(f"B2-tile128 vs plain rel err {rel:.3e}, {v1_rel:.3e}")
    ts = alternate(lambda: ps.gather_gemm_accumulate_stream(*sargs),
                   lambda: ps.gather_gemm_accumulate_stream_reference(*sargs))
    tv = alternate(lambda: pallas_gemm.gather_gemm_accumulate(*sargs),
                   lambda: pallas_gemm.gather_gemm_accumulate_reference(*sargs))
    tsp = in_turns({"planned spgemm": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan)})
    flops = 2 * 128**3 * pc
    nbytes = A.data.numel() * 4 + 3 * pc * 4 + oc * 128 * 128 * 4
    b2t_bound = bound(flops, nbytes, "tf32x3")
    sdev = device_profile("stream kernel at B2-tile128",
                          lambda: ps.gather_gemm_accumulate_stream(*sargs), 10, card, top=3)
    vdev = device_profile("gather_gemm_accumulate at B2-tile128",
                          lambda: pallas_gemm.gather_gemm_accumulate(*sargs), 10, card, top=3)
    s_bounds = tile_bounds(flops, nbytes, per_call_us(sdev, 10, "stream_kernel"))
    v_bounds = tile_bounds(flops, nbytes, per_call_us(vdev, 10, "stream_kernel"))
    bmm_ms = bmm_yardstick(A.data, A.data, plan.a_idx[:pc], plan.b_idx[:pc])
    print(f"[time] {card}: B2-tile128, CUDA events, median of 7 after 2 warm-up calls, "
          f"in turns plain, kernel, kernel, plain; bounds FP32 "
          f"{s_bounds['bound_fp32_ms']:.4f} ms, 3xTF32 {b2t_bound[0]:.4f} ms ({b2t_bound[1]})")
    for name, (_, _, four), b in (("stream kernel", ts, s_bounds),
                                  ("gather_gemm_accumulate", tv, v_bounds)):
        print(f"[time]   {name:24s} kernel {four[0]:.4f} / {four[1]:.4f} ms "
              f"({flops / four[0] / 1e9:.1f} TFLOP/s)   plain {four[2]:.4f} / {four[3]:.4f} ms; "
              f"kernel {1e3 * (b['device_ms'] or 0):.1f} us per launch: {pct(b['share_fp32'])} "
              f"of FP32, {pct(b['share_route'])} of 3xTF32")
    t1, t2 = tsp["planned spgemm"]
    print(f"[time]   planned spgemm (auto -> 'pallas') {t1:.4f} / {t2:.4f} ms")
    print(f"[time]   yardstick: torch.bmm over the {pc} gathered pairs, TF32 off: "
          f"{bmm_ms:.4f} ms (the products alone, without their sum into slots)")
    device_profile("planned B2-tile128 spgemm (auto -> 'pallas')",
                   lambda: hbsm.spgemm(A, A, pc, oc, plan=plan), 10, card, top=5)
    entries = {
        "gather_gemm_accumulate_stream": dict(max_abs_err=abs_err, ms=ts[0], plain_ms=ts[1],
                                              bound=b2t_bound, library_ms=None, **s_bounds),
        "gather_gemm_accumulate": dict(max_abs_err=v1_err, ms=tv[0], plain_ms=tv[1],
                                       bound=b2t_bound, library_ms=None, **v_bounds),
    }
    return entries, got["gather_gemm_accumulate_stream"], v1["gather_gemm_accumulate"]


def flags_set(info) -> list:
    return [f for f in ("pair_overflow", "out_overflow", "row_overflow", "plan_mismatch")
            if bool(getattr(info, f))]


def b4_small(card):
    """Phase 15, B4 at 8192² (bench.py:831-840): the host plans and the
    backend auto runs, the planned spgemm and spgemm_colslab(n_slabs=4)
    against the counters, an f64 product and each other (bitwise), the
    row-panel kernel against its plain version, times in turns, and the
    kernel's device time against both bounds.  Returns the kernel
    launches of its path."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as pr
    from hierarchical_block_sparse_lib_tpu_torch.ops.slab import plan_colslab
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
        matmul_precision,
        plan_spgemm_ex,
        resolve_backend,
    )
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix

    A = random_block_matrix(8192, 128, 0.5, seed=4)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    gplan = hbsm.plan_groups(A, A)
    caps = dict(row_caps=(mbr, mcr), group_caps=gplan.caps if gplan is not None else None)
    backend = resolve_backend(A.block_size, A.dtype, A.nb_cols, pc, **caps)
    plan = hbsm.make_plan(A, A, pc)
    cplan = plan_colslab(A, A, 4)
    print(f"[B4] 8192^2 b=128 50% seed 4: {int(A.nnz)} blocks, pairs {pc}, out {oc}, row caps "
          f"({mbr}, {mcr}), {pc / oc:.1f} products a slot; plan_groups -> "
          f"{gplan.caps if gplan is not None else None}; auto -> {backend!r}")
    torch.cuda.synchronize()
    reset_counts()
    C, info = hbsm.spgemm(A, A, pc, oc, plan=plan, **caps)
    Cs, si = hbsm.spgemm_colslab(A, A, n_slabs=4)
    torch.cuda.synchronize()
    kernel = "groups_spgemm" if backend == "groups" else "rows_spgemm"
    want = {"rows_spgemm": 4}
    want[kernel] = want.get(kernel, 0) + 1
    got = launched(want, "B4 8192^2 (planned spgemm, spgemm_colslab x4)")
    for name, i in (("planned spgemm", info), ("spgemm_colslab", si)):
        n = (int(i.n_block_pairs), int(i.n_out_blocks))
        if n != (pc, oc) or flags_set(i):
            raise AssertionError(f"B4 {name}: counters {n} vs plan ({pc}, {oc}), flags {flags_set(i)}")
    if cplan.total_pairs != pc or cplan.n_out != oc:
        raise AssertionError(f"B4 colslab plan ({cplan.total_pairs}, {cplan.n_out})")
    dA = hbsm.to_dense(A).double()
    err = rel_err(hbsm.to_dense(C).double(), dA @ dA)
    del dA
    print(f"[B4] launches {got}; counters as planned, no flag; planned spgemm vs f64 "
          f"product: rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"B4 rel err {err:.3e} > 1e-5")
    # The same kernel unsplit: slabs give each slot the same products in
    # the same order, so the bits must agree.
    Cu = C if backend == "rows" else hbsm.spgemm(A, A, pc, oc, plan=plan, backend="rows",
                                                 row_caps=(mbr, mcr))[0]
    same = torch.equal(Cs.ids, Cu.ids) and torch.equal(Cs.data, Cu.data)
    diff = rel_err(Cs.data, Cu.data) if torch.equal(Cs.ids, Cu.ids) else float("inf")
    print(f"[B4] spgemm_colslab(n_slabs=4) vs the unsplit product on 'rows': "
          f"{'bitwise equal' if same else f'NOT bitwise equal, rel diff {diff:.3e}'}")
    if not same and not diff <= 1e-6:
        raise AssertionError(f"B4 colslab vs unsplit rel diff {diff:.3e} > 1e-6")
    del Cs, Cu
    rargs = (A.ids, A.data, A.ids, A.data, C.ids, A.nb_rows, A.nb_rows, A.nb_cols, oc, mbr, mcr)
    rk = pr.rows_spgemm(*rargs)
    rp = pr.rows_spgemm_reference(*rargs)
    torch.cuda.synchronize()
    abs_err, rel = float((rk - rp).abs().max()), rel_err(rk, rp)
    del rk, rp
    print(f"[B4] rows_spgemm vs plain ({pr.PLAIN_PAIR_CHUNK} pairs a batched product): "
          f"max abs err {abs_err:.3e}, rel {rel:.3e}")
    if rel > ROWS_TOL:
        raise AssertionError(f"B4 rows_spgemm vs plain rel err {rel:.3e}")
    D = hbsm.to_dense(A)

    def dense():
        with matmul_precision("highest", D.device):  # TF32 off
            torch.matmul(D, D)

    times = in_turns({
        "planned spgemm": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, **caps),
        "spgemm_colslab": lambda: hbsm.spgemm_colslab(A, A, plan=cplan),
        "dense matmul": dense,
    })
    flops, nbytes = 2 * 128**3 * pc, A.data.numel() * 4 + oc * 128 * 128 * 4
    dev = device_profile("rows_spgemm at B4 8192^2", lambda: pr.rows_spgemm(*rargs), 5, card,
                         top=3)
    b = tile_bounds(flops, nbytes, per_call_us(dev, 5, "rows_spgemm_kernel"))
    print(f"[time] {card}: B4 8192^2, CUDA events, median of 7 after 2 warm-up calls, "
          f"in order then reversed (the colslab call with its plan)")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:15s} {t1:.3f} / {t2:.3f} ms"
              + ("  (8192^2 f32, TF32 off)" if name == "dense matmul" else ""))
    print(f"[time]   {card}: rows_spgemm {1e3 * (b['device_ms'] or 0):.1f} us per launch "
          f"({pc} products); bounds FP32 {b['bound_fp32_ms']:.3f} ms ({pct(b['share_fp32'])}), "
          f"3xTF32 {b['bound_route_ms']:.3f} ms ({pct(b['share_route'])})")
    return got


def b4_full(card):
    """Phase 15, B4 at its configured size (BASELINE.json:10, bench.py:
    267-300 and 844-850): 32768², 50% block density, through
    plan_colslab(8) and spgemm_colslab on the row-panel kernel, against the
    plan's counters and an f64 product taken one slab of columns at a
    time; then the call, the slab-wise dense anchor (bench.py:323-353) and
    the whole dense product in turns, the kernel's device time, the
    bounds and the peak memory.  Returns the kernel launches of its path."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.slab import plan_colslab
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import matmul_precision
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix

    n, n_slabs = 32768, 8
    t0 = time.perf_counter()
    A = random_block_matrix(n, 128, 0.5, seed=4)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_colslab(A, A, n_slabs)
    plan_s = time.perf_counter() - t0
    print(f"[B4full] {n}^2 b=128 50% seed 4: {int(A.nnz)} blocks "
          f"({A.data.numel() * 4 / 1e9:.2f} GB), made in {gen_s:.1f} s; plan_colslab({n_slabs}) "
          f"{plan_s:.2f} s on the host: pairs {plan.total_pairs}, out {plan.n_out} blocks "
          f"({plan.n_out * 128 * 128 * 4 / 1e9:.2f} GB), "
          f"{plan.total_pairs / plan.n_out:.1f} products a slot")
    for k, sl in enumerate(plan.slabs):
        print(f"[B4full]   slab {k}: cols [{sl.j0}, {sl.j1}), B blocks {sl.cap}, pairs "
              f"{sl.pair_cap}, out {sl.out_cap}, row caps {sl.row_caps}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    C, info = hbsm.spgemm_colslab(A, A, plan=plan)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = launched({"rows_spgemm": n_slabs}, "B4full (spgemm_colslab)")
    peak_call = torch.cuda.max_memory_allocated() - base
    cnt = (int(info.n_block_pairs), int(info.n_out_blocks))
    if cnt != (plan.total_pairs, plan.n_out) or flags_set(info):
        raise AssertionError(f"B4full counters {cnt} vs plan, flags {flags_set(info)}")
    print(f"[B4full] launches {got}; first call {first_s:.2f} s; counters {cnt} as planned, no "
          f"flag; the call's peak above its inputs {peak_call / 2**30:.2f} GiB")
    dA = hbsm.to_dense(A).double()
    dC = hbsm.to_dense(C)
    del C
    w = A.n_cols // n_slabs
    worst = scale = 0.0
    for s in range(n_slabs):
        exact = dA @ dA[:, s * w:(s + 1) * w]
        scale = max(scale, float(exact.abs().max()))
        worst = max(worst, float((dC[:, s * w:(s + 1) * w].double() - exact).abs().max()))
        del exact
    err = worst / scale
    del dA, dC
    torch.cuda.empty_cache()
    print(f"[B4full] vs the f64 product (one slab of columns at a time): rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"B4full rel err {err:.3e} > 1e-5")
    D = hbsm.to_dense(A)

    def slabwise():
        with matmul_precision("highest", D.device):  # TF32 off
            for s in range(n_slabs):
                torch.matmul(D, D[:, s * w:(s + 1) * w])

    def whole():
        with matmul_precision("highest", D.device):
            torch.matmul(D, D)

    # Median of 3 after 1 warm-up: the two dense anchors take about 1.3 s a
    # call, and 7 after 2 would cost the script some 30 s more.
    times = in_turns({"spgemm_colslab": lambda: hbsm.spgemm_colslab(A, A, plan=plan),
                      "dense slab-wise": slabwise, "dense whole": whole}, warmup=1, reps=3)
    del D
    torch.cuda.empty_cache()
    flops = 2 * 128**3 * plan.total_pairs
    nbytes = A.data.numel() * 4 + plan.n_out * 128 * 128 * 4
    dev = device_profile("spgemm_colslab at B4full", lambda: hbsm.spgemm_colslab(A, A, plan=plan),
                         2, card, unit="call", top=6)
    b = tile_bounds(flops, nbytes, per_call_us(dev, 2, "rows_spgemm_kernel"))
    call = statistics.median(times["spgemm_colslab"])
    dense_whole = statistics.median(times["dense whole"])
    dense_slab = statistics.median(times["dense slab-wise"])
    print(f"[time] {card}: B4full, CUDA events, median of 3 after 1 warm-up call, in order "
          f"then reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:15s} {t1:.1f} / {t2:.1f} ms"
              + ("" if name == "spgemm_colslab" else f"  ({n}^2 f32, TF32 off)"))
    per_launch = None if b["device_ms"] is None else 1e3 * b["device_ms"] / n_slabs
    print(f"[time]   {card}: rows_spgemm "
          + ("not measured" if per_launch is None else f"{per_launch:.1f} us")
          + f" per slab launch ({plan.total_pairs / n_slabs:.0f} products; bounds a launch FP32 "
          f"{b['bound_fp32_ms'] / n_slabs:.2f} ms, 3xTF32 {b['bound_route_ms'] / n_slabs:.2f} ms); "
          f"the call's kernels against bounds FP32 {b['bound_fp32_ms']:.1f} ms "
          f"({pct(b['share_fp32'])}), 3xTF32 {b['bound_route_ms']:.1f} ms "
          f"({pct(b['share_route'])}); bytes {1e3 * nbytes / 3.35e12:.2f} ms")
    print(f"[time]   {card}: the call {call:.1f} ms = {100 * b['bound_route_ms'] / call:.1f}% of the "
          f"{b['bound_route_ms']:.1f} ms 3xTF32 bound; {dense_whole / call:.2f}x faster than the "
          f"whole dense product, {dense_slab / call:.2f}x faster than the slab-wise one; peak "
          f"device memory of the phase {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return got


def band_tier(card, b1):
    """Phase 15, B1's band tier (bench.py:727-764): band_from_blocks and
    band_mm on the leaf-16 banded 4096^2, band 64, against the f64 oracle
    and phase 12's product (band_to_blocks, coarsened x8 as phase 12's
    input), and leafpack on the same input; both timed in turns with phase
    12's planned spgemm on "pallas"."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm

    a16 = b1["a16"]
    torch.cuda.synchronize()
    reset_counts()
    Ab = hbsm.band_from_blocks(a16, 64)
    Cb = hbsm.band_mm(Ab, Ab)
    lplan = hbsm.plan_leafpack(a16, a16)
    Cl, li = hbsm.leafpack_spgemm(a16, a16, lplan)
    torch.cuda.synchronize()
    launched({}, "band tier and leafpack (torch.bmm, no kernel of the port)")
    d16 = hbsm.to_dense(a16).double()
    exact = d16 @ d16
    del d16
    err_b = rel_err(hbsm.band_to_dense(Cb).double(), exact)
    coarse = hbsm.band_to_blocks(Cb, 16)
    coarse = hbsm.coarsen(coarse, 8, cap=hbsm.plan_coarsen(coarse, 8))
    err_12 = rel_err(hbsm.to_dense(coarse), hbsm.to_dense(b1["C"]))
    err_l = rel_err(hbsm.to_dense(Cl).double(), exact)
    n_leaf = int(li.n_leaf_multiplies)
    print(f"[band] B1 band tier: {Ab}, C {Cb}; vs f64 oracle rel err {err_b:.3e}; "
          f"band_to_blocks(16) coarsened x8 vs phase 12's product rel err {err_12:.3e}")
    print(f"[band] leafpack: S={lplan.strips} La={lplan.la} Lc={lplan.lc}, inflation "
          f"{lplan.inflation:.2f}x, leaf multiplies {n_leaf}, out {int(li.n_out_blocks)}; vs f64 "
          f"oracle rel err {err_l:.3e}")
    if max(err_b, err_12, err_l) > 1e-5:
        raise AssertionError(f"band tier rel errs {err_b:.3e}, {err_12:.3e}, {err_l:.3e}")
    if n_leaf != b1["fine_pairs"] or flags_set(li):
        raise AssertionError(f"leafpack counter {n_leaf} vs {b1['fine_pairs']}, flags {flags_set(li)}")
    times = in_turns({"band_mm": lambda: hbsm.band_mm(Ab, Ab),
                      "leafpack_spgemm": lambda: hbsm.leafpack_spgemm(a16, a16, lplan),
                      "planned spgemm on 'pallas'": b1["pallas"]})
    print(f"[time] {card}: B1, CUDA events, median of 7 after 2 warm-up calls, in order then "
          f"reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:27s} {t1:.4f} / {t2:.4f} ms")


def kpack_b2(card, b2):
    """Phase 15, B2's packed contraction (bench.py:585-648): plan_kpack at
    the configured B2, its product against phase 4's planned fine product
    coarsened to 128-wide tiles, and both timed in turns."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm

    A, Af, plan, pc, oc, caps = b2
    t0 = time.perf_counter()
    kplan = hbsm.plan_kpack(A, A, tile=128, n_groups=32)
    plan_s = time.perf_counter() - t0
    print(f"[kpack] B2: plan_kpack {plan_s:.2f} s on the host: tiles {kplan.n_tiles}, A columns "
          f"{kplan.n_a_cols}, B rows {kplan.n_b_rows}, {len(kplan.a_src)} groups, panel "
          f"inflation {kplan.inflation:.2f}x ({kplan.panel_flops / 1e9:.1f} GFLOP of panels), "
          f"leaf pairs {kplan.n_leaf_pairs}")
    if kplan.n_leaf_pairs != pc:
        raise AssertionError(f"kpack leaf pairs {kplan.n_leaf_pairs} vs the fine plan's {pc}")
    torch.cuda.synchronize()
    reset_counts()
    Ck, ki = hbsm.kpack_spgemm(A, A, kplan)
    Cf, _ = hbsm.fine_matmul(Af, Af, pc, oc, caps, plan=plan)
    torch.cuda.synchronize()
    launched({"fine_spgemm": 1}, "kpack and its reference (planned fine_matmul)")
    cf = hbsm.fine_unpack(Cf)
    ref = hbsm.coarsen(cf, 4, cap=hbsm.plan_coarsen(cf, 4))
    if not torch.equal(Ck.ids, ref.ids) or flags_set(ki):
        raise AssertionError(f"kpack tiles differ from the coarsened fine product, flags "
                             f"{flags_set(ki)}")
    err = rel_err(Ck.data, ref.data)
    del cf, ref, Cf
    print(f"[kpack] vs phase 4's planned fine product coarsened x4: ids equal, rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"kpack rel err {err:.3e} > 1e-5")
    times = in_turns({"kpack_spgemm": lambda: hbsm.kpack_spgemm(A, A, kplan),
                      "planned fine_matmul": lambda: hbsm.fine_matmul(Af, Af, pc, oc, caps,
                                                                      plan=plan)})
    print(f"[time] {card}: B2, CUDA events, median of 7 after 2 warm-up calls, in order then "
          f"reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:20s} {t1:.3f} / {t2:.3f} ms")


def spmm_b2(card, b2):
    """Phase 15, spmm and spmv at B2's A with a 128-column dense right-hand
    side, against f64, and their times."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm

    A = b2[0]
    rng = np.random.default_rng(9)
    X = torch.from_numpy(rng.standard_normal((A.n_cols, 128)).astype(np.float32)).to(DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    Y = hbsm.spmm(A, X)
    y = hbsm.spmv(A, X[:, 0])
    torch.cuda.synchronize()
    launched({}, "spmm and spmv (torch.bmm, no kernel of the port)")
    dA = hbsm.to_dense(A).double()
    exact = dA @ X.double()
    del dA
    err, err_v = rel_err(Y.double(), exact), rel_err(y.double(), exact[:, 0])
    print(f"[spmm] B2's A @ X[{A.n_cols}, 128]: vs f64 rel err {err:.3e}; spmv {err_v:.3e}")
    if max(err, err_v) > 1e-5:
        raise AssertionError(f"spmm/spmv rel err {err:.3e}, {err_v:.3e}")
    times = in_turns({"spmm": lambda: hbsm.spmm(A, X), "spmv": lambda: hbsm.spmv(A, X[:, 0])})
    print(f"[time] {card}: spmm / spmv at B2, CUDA events, median of 7 after 2 warm-up calls")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:5s} {t1:.4f} / {t2:.4f} ms")


def occupancy_phase(card, b1, b2):
    """Phase 15: the occupancy tiers and B4.  Returns rows_spgemm's
    launches on its paths (B4 at 8192^2 and at 32768^2)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[mem] {card}: before phase 15 {torch.cuda.memory_allocated() / 2**30:.2f} GiB in use")
    small = b4_small(card)
    torch.cuda.empty_cache()
    full = b4_full(card)
    torch.cuda.empty_cache()
    band_tier(card, b1)
    kpack_b2(card, b2)
    spmm_b2(card, b2)
    rows = small.get("rows_spgemm", 0) + full["rows_spgemm"]
    print(f"[phase15] {time.perf_counter() - t0:.1f} s; rows_spgemm launches {rows} "
          f"(B4 8192^2 {small.get('rows_spgemm', 0)}, B4full {full['rows_spgemm']})")
    return rows, small.get("groups_spgemm", 0)


def host_peak_bytes(fn, period_s=5e-4):
    """(fn(), bytes): the process's peak resident host memory during fn()
    above its resident memory before, from /proc/self/status's VmRSS
    sampled every `period_s` by a thread (the interpreter's switch
    interval is cut to match, so the sampler gets its turns)."""
    import threading

    def rss():
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))

    before = rss()
    peak = [before]
    done = threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], rss())
            time.sleep(period_s)

    old = sys.getswitchinterval()
    sys.setswitchinterval(period_s)
    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        out = fn()
        peak[0] = max(peak[0], rss())
    finally:
        done.set()
        thread.join()
        sys.setswitchinterval(old)
    return out, peak[0] - before


def class_b1(card, b1):
    """Phase 16, B1 through the class (bench.py:711-713): Params(16),
    resize(4096), assign_from_vectors(banded_coo(4096, 64, seed=0)) and
    multiply(A, False, A, False) on the band tier, band-resident, against
    the f64 product; frob band-side; timed beside phase 12's planned
    product on "pallas"."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.band import band_pair_count
    from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen

    HB = hbsm.HierarchicalBlockSparseMatrix
    n, bw = 4096, 64
    torch.cuda.synchronize()
    reset_counts()
    a = HB(hbsm.Params(16))
    a.resize(n)
    a.assign_from_vectors(*gen.banded_coo(n, bw, seed=0))
    c = HB.multiply(a, False, a, False)
    frob = c.get_frob_squared()
    torch.cuda.synchronize()
    launched({}, "B1 through the class (the band tier: torch.bmm, no kernel of the port)")
    if c._band is None or c._m is not None or a._m.device.type != torch.device(DEVICE).type:
        raise AssertionError("B1 through the class is not band-resident on the card")
    d16 = hbsm.to_dense(b1["a16"]).double()
    exact = d16 @ d16
    del d16
    err = rel_err(hbsm.band_to_dense(c._band).double(), exact)
    frob_err = abs(frob - float((exact * exact).sum())) / float((exact * exact).sum())
    del exact
    pairs = c.no_of_block_multiplies
    wb = (a._band_w + 1 + 15) // 16 - 1
    print(f"[class] B1: {a.get_nnz_blocks()} blocks of 16, band w={a._band_w} (block halfwidth "
          f"{wb}); multiply band-resident (block form never built: {c._m is None}); counter "
          f"{pairs} (leaf-16 pairs {b1['fine_pairs']}); vs f64 rel err {err:.3e}; "
          f"get_frob_squared band-side rel err {frob_err:.3e}")
    if pairs != b1["fine_pairs"] or pairs != band_pair_count(n // 16, wb):
        raise AssertionError(f"B1 class counter {pairs} vs the block path's {b1['fine_pairs']}")
    if max(err, frob_err) > 1e-5:
        raise AssertionError(f"B1 class rel errs {err:.3e}, {frob_err:.3e}")
    times = in_turns({"class multiply (band tier)": lambda: HB.multiply(a, False, a, False),
                      "planned spgemm on 'pallas'": b1["pallas"]})
    print(f"[time] {card}: B1, CUDA events, median of 7 after 2 warm-up calls, in order then "
          f"reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:27s} {t1:.4f} / {t2:.4f} ms")


def class_b2(card, b2, tmp_dir):
    """Phase 16, B2 through the class (BASELINE.json:8): two multiplies of
    phase 4's A through from_block_matrix (one host plan, one fine_spgemm
    launch each, bitwise equal to spgemm(backend="fine", plan=), against
    the f64 product), its time beside phase 4's planned fine_matmul;
    frob_block_trunc on a copy; get_all_values (triplets, peak host
    memory); save/load bitwise.  Returns fine_spgemm's launches."""
    import os

    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    import hierarchical_block_sparse_lib_tpu_torch.api as api

    HB = hbsm.HierarchicalBlockSparseMatrix
    A, Af, plan, pc, oc, caps = b2
    HB._plan_cache.clear()
    planner = api.plan_spgemm_ex
    calls = []

    def counting(*args):
        calls.append(1)
        return planner(*args)

    api.plan_spgemm_ex = counting
    try:
        m = HB.from_block_matrix(A)
        torch.cuda.synchronize()
        reset_counts()
        c1 = HB.multiply(m, False, m, False)
        n1 = counts(("fine_spgemm",))["fine_spgemm"]
        c2 = HB.multiply(m, False, m, False)
        torch.cuda.synchronize()
        launches = counts(("fine_spgemm",))["fine_spgemm"]
        launched({"fine_spgemm": 2}, "two B2 multiplies through the class")
    finally:
        api.plan_spgemm_ex = planner
    (cplan, cpc, coc, crc), = HB._plan_cache.values()
    cm, info = hbsm.spgemm(A, A, cpc, coc, plan=cplan, row_caps=crc, backend="fine")
    same = all(torch.equal(x.block_matrix.ids, cm.ids) and torch.equal(x.block_matrix.data, cm.data)
               for x in (c1, c2))
    counters = (c1.no_of_block_multiplies, c2.no_of_block_multiplies)
    print(f"[class] B2: host planner calls {len(calls)} for two multiplies; fine_spgemm "
          f"launches {n1} then {launches - n1}; counters {counters}; bitwise equal to "
          f"spgemm(backend='fine', plan=): {same}")
    if len(calls) != 1 or n1 != 1 or not same or counters != (pc, pc) or flags_set(info):
        raise AssertionError(f"B2 class: planner {len(calls)}, launches {n1}/{launches}, "
                             f"bitwise {same}, counters {counters} vs {pc}, {flags_set(info)}")
    dA = hbsm.to_dense(A).double()
    exact = dA @ dA
    del dA
    err = rel_err(hbsm.to_dense(c1.block_matrix).double(), exact)
    del exact
    print(f"[class] B2 product vs the f64 product: rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"B2 class rel err {err:.3e} > 1e-5")
    times = in_turns({
        "class multiply": lambda: HB.multiply(m, False, m, False),
        "spgemm(backend='fine', plan=)": lambda: hbsm.spgemm(
            A, A, cpc, coc, plan=cplan, row_caps=crc, backend="fine"),
        "planned fine_matmul (phase 4)": lambda: hbsm.fine_matmul(Af, Af, pc, oc, caps,
                                                                  plan=plan),
    })
    print(f"[time] {card}: B2, CUDA events, median of 7 after 2 warm-up calls, in order then "
          f"reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:30s} {t1:.3f} / {t2:.3f} ms")

    # frob_block_trunc on a copy: the copy drops blocks, the original keeps
    # its own (at leaf 32 the norms are a torch reduction, no kernel).
    cb = c1.block_matrix
    tau = midpoint_tau(hbsm.block_frob_squared(cb)[:int(cb.nnz)].sqrt().cpu().numpy())
    before = c1.get_nnz_blocks()
    cut = c1.copy()
    reset_counts()
    cut.frob_block_trunc(tau)
    torch.cuda.synchronize()
    want = hbsm.truncate(c1.block_matrix, tau)
    if not (torch.equal(cut.block_matrix.ids, want.ids)
            and torch.equal(cut.block_matrix.data, want.data)) or c1.get_nnz_blocks() != before:
        raise AssertionError("B2 frob_block_trunc on a copy differs from truncate or leaks")
    print(f"[class] B2 frob_block_trunc(tau={tau:.4g}) on a copy: {before} -> "
          f"{cut.get_nnz_blocks()} blocks, equal to truncate; the original keeps {before}; "
          f"launches {counts(('norms_and_keep',))} (leaf 32: torch reduction)")

    t0 = time.perf_counter()
    (rows, cols, vals), peak = host_peak_bytes(m.get_all_values)
    secs = time.perf_counter() - t0
    n_trip = rows.size
    frob = float(hbsm.frob_squared(A))
    v64 = float(np.square(vals, dtype=np.float64).sum())
    want_trip = int(torch.count_nonzero(A.data[:int(A.nnz)]))
    idx = np.random.default_rng(0).integers(0, n_trip, 1000)
    got_vals = m.get_values(rows[idx], cols[idx])
    result_bytes = rows.nbytes + cols.nbytes + vals.nbytes
    print(f"[class] B2 get_all_values: {n_trip} triplets ({result_bytes / 2**20:.1f} MiB) in "
          f"{secs:.2f} s, chunks of 2048 blocks ({2048 * 32 * 32 * 12 / 2**20:.1f} MiB); peak "
          f"host memory above the start {peak / 2**20:.1f} MiB (VmRSS sampled every 0.5 ms)")
    if n_trip != want_trip or abs(v64 - frob) > 1e-5 * frob or not np.array_equal(got_vals,
                                                                                  vals[idx]):
        raise AssertionError(f"B2 get_all_values: {n_trip} triplets vs {want_trip}, sum of "
                             f"squares {v64} vs {frob}")
    del rows, cols, vals

    path = os.path.join(tmp_dir, "b2.npz")
    hbsm.save(path, A)
    back = hbsm.load(path)
    size = os.path.getsize(path)
    os.remove(path)
    if not (back.device.type == torch.device(DEVICE).type and torch.equal(back.ids[:int(A.nnz)], A.ids[:int(A.nnz)])
            and torch.equal(back.data[:int(A.nnz)], A.data[:int(A.nnz)])
            and int(back.nnz) == int(A.nnz)):
        raise AssertionError("B2 save/load is not bitwise")
    print(f"[class] B2 save/load on the card: bitwise, {size / 2**20:.1f} MiB file")
    return 2


def syrk_b3(card, A):
    """Phase 16, syrk at B3's input (b=128): plan_syrk, syrk on "rows"
    (rows_spgemm with triu) against matmul(A, A, transpose_b=True) and the
    f64 product; the kernel against its plain version at that shape, its
    device time per launch and both bounds.  Returns its launches."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as rows
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm

    plan = hbsm.plan_syrk(A)
    torch.cuda.synchronize()
    reset_counts()
    C, info = hbsm.syrk(A)
    torch.cuda.synchronize()
    got = launched({"rows_spgemm": 1}, "syrk at B3")
    full, _ = plan_spgemm(A, hbsm.transpose(A))
    print(f"[syrk] B3 input: pairs_upper {plan.pairs_upper} of pairs_raw {plan.pairs_raw} "
          f"({plan.pairs_upper / plan.pairs_raw:.3f}); out {plan.out_upper} upper, "
          f"{plan.out_full} mirrored; launches {got}")
    if (int(info.n_block_pairs), plan.pairs_raw) != (plan.pairs_upper, full) or flags_set(info):
        raise AssertionError(f"syrk counters {int(info.n_block_pairs)} / {plan.pairs_raw}, "
                             f"flags {flags_set(info)}")
    M, _ = hbsm.matmul(A, A, transpose_b=True)
    d = hbsm.to_dense(A).double()
    exact = d @ d.T
    del d
    dense = hbsm.to_dense(C)
    err_m, err_x = rel_err(dense, hbsm.to_dense(M)), rel_err(dense.double(), exact)
    del exact, dense
    print(f"[syrk] vs matmul(A, A, transpose_b=True) rel err {err_m:.3e}, vs f64 {err_x:.3e}")
    if max(err_m, err_x) > 1e-5:
        raise AssertionError(f"syrk rel errs {err_m:.3e}, {err_x:.3e}")
    at = hbsm.transpose(A)
    cu, _ = hbsm.syrk(A, full=False)
    rargs = (A.ids, A.data, at.ids, at.data, cu.ids, A.nb_rows, at.nb_rows, at.nb_cols,
             cu.cap, plan.max_b_row, plan.max_c_row)
    # Host check of the skip's predicate: the pairs of the kernel's row
    # tables whose column is >= the A block's row, against the symbolic
    # filter's count.
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf

    _, a_col, b_row_start, b_col, _, _ = pf.build_tables(
        A.ids, at.ids, cu.ids, A.nb_rows, at.nb_rows, at.nb_cols)
    a_idx, b_idx = pf.expand_pairs(A.ids, a_col, b_row_start, plan.max_b_row)
    kept = int((b_col[b_idx].long() >= A.ids[a_idx].long() // A.nb_cols).sum())
    print(f"[syrk] host check of the triu predicate: {kept} of {a_idx.numel()} pairs; the "
          f"symbolic filter {int(info.n_block_pairs)}")
    if (kept, a_idx.numel()) != (plan.pairs_upper, plan.pairs_raw):
        raise AssertionError(f"triu predicate keeps {kept} pairs, the symbolic filter "
                             f"{plan.pairs_upper}")
    # The kernel's own skip: on the mirrored output (both triangles) a
    # triu launch leaves every strictly lower slot zero and writes the
    # upper slots bitwise as a launch without the skip does.  A slot's
    # pairs share its (row, column), so this holds the skip pair for pair.
    full_args = rargs[:4] + (C.ids,) + rargs[5:8] + (C.cap,) + rargs[9:]
    k_up = rows.rows_spgemm(*full_args, triu=True)
    k_all = rows.rows_spgemm(*full_args, triu=False)
    valid = C.ids != hbsm.SENTINEL
    lower = valid & (C.ids // C.nb_cols > C.ids % C.nb_cols)
    upper = valid & ~lower
    n_low = int(lower.sum())
    low_zero = bool((k_up[lower] == 0).all())
    low_hit = int((k_all[lower] != 0).flatten(1).any(1).sum())
    up_equal = torch.equal(k_up[upper], k_all[upper])
    print(f"[syrk] the kernel's triu skip on the {int(valid.sum())} mirrored slots: the "
          f"{n_low} strictly lower ones all zero {low_zero} ({low_hit} nonzero without "
          f"the skip); the {int(upper.sum())} upper ones bitwise as without it {up_equal}")
    if not (low_zero and up_equal and low_hit == n_low == plan.out_full - plan.out_upper):
        raise AssertionError(f"triu skip: lower zero {low_zero}, upper equal {up_equal}, "
                             f"lower slots {n_low} ({low_hit} hit without the skip)")
    del k_up, k_all
    k = rows.rows_spgemm(*rargs, triu=True)
    p = rows.rows_spgemm_reference(*rargs, triu=True)
    rel = rel_err(k, p)
    print(f"[syrk] rows_spgemm(triu=True) vs plain at {plan.pairs_upper} pairs, out_cap "
          f"{cu.cap}: max abs err {float((k - p).abs().max()):.3e}, rel {rel:.3e}")
    if rel > ROWS_TOL:
        raise AssertionError(f"syrk rows_spgemm(triu) rel err {rel:.3e}")
    k_ms, p_ms, four = alternate(lambda: rows.rows_spgemm(*rargs, triu=True),
                                 lambda: rows.rows_spgemm_reference(*rargs, triu=True))
    dev = device_profile("rows_spgemm(triu=True) at B3's syrk", lambda: rows.rows_spgemm(
        *rargs, triu=True), 10, card, top=3)
    # Bytes: A's and A^T's stored blocks read once (not their capacity),
    # every output slot written once.
    bnd = tile_bounds(2 * 128**3 * plan.pairs_upper,
                      stored_bytes(A) + stored_bytes(at) + cu.cap * 128 * 128 * 4,
                      per_call_us(dev, 10, "rows_spgemm_kernel"))
    syrk_ms = cuda_time_ms(lambda: hbsm.syrk(A))[0]
    mm_ms = cuda_time_ms(lambda: hbsm.matmul(A, A, transpose_b=True))[0]
    print(f"[time] {card}: syrk at B3, CUDA events, median of 7 after 2 warm-up calls")
    print(f"[time]   rows_spgemm(triu) kernel {four[0]:.4f} / {four[1]:.4f} ms   plain "
          f"{four[2]:.4f} / {four[3]:.4f} ms; kernel "
          + ("not measured" if bnd["device_ms"] is None else f"{1e3 * bnd['device_ms']:.1f} us")
          + f" per launch: bounds FP32 {bnd['bound_fp32_ms']:.4f} ms ({pct(bnd['share_fp32'])}), "
          f"3xTF32 {bnd['bound_route_ms']:.4f} ms ({pct(bnd['share_route'])})")
    print(f"[time]   syrk call {syrk_ms:.4f} ms; matmul(A, A, transpose_b=True) {mm_ms:.4f} ms")
    return got["rows_spgemm"]


def symmetric_b3(card, A, prof, plans, scan):
    """Phase 16, symmetric SP2 at B3 (5 steps, tau = 1e-6):
    profile_purify(symmetric=True), plan_purify(symmetric=True),
    purify_scan(symmetric=True) unplanned and planned (no host sync),
    against phase 7's generic scan (pairs per step), the float64 path and
    phase 7's iterate; exactly symmetric; launches and times in turns.
    Returns the launches of rows_spgemm and norms_and_keep."""
    import dataclasses

    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm

    n, steps, tau = A.n_rows, 5, 1e-6
    xg, sg = scan
    torch.cuda.synchronize()
    reset_counts()
    prof_s = hbsm.profile_purify(A, steps, tau, target_trace=n / 2, symmetric=True)
    # The planned symmetric step runs on the generic union: caps that
    # cover both trajectories.
    caps = {k: max(getattr(prof, k), getattr(prof_s, k)) for k in ("pair_cap", "out_cap", "cap")}
    caps["row_caps"] = tuple(max(x, y) for x, y in zip(prof.row_caps, prof_s.row_caps))
    prof_run = dataclasses.replace(prof, **caps)
    plans_s = hbsm.plan_purify(A, steps, tau, prof_run, target_trace=n / 2, symmetric=True)
    kw = dict(target_trace=n / 2, symmetric=True, **prof_run.kwargs())
    c0 = counts()
    xu, su = hbsm.purify_scan(A, steps, tau, **kw)
    c1 = counts()
    with no_host_sync():
        xp, sp = hbsm.purify_scan(A, steps, tau, plans=plans_s, **kw)
    c2 = counts()
    torch.cuda.synchronize()
    print(f"[sym] B3 profile_purify(symmetric=True): pairs {prof_s.per_step_pairs}, union "
          f"{prof_s.per_step_out}, kept {prof_s.per_step_kept}; run caps {caps}")
    for name, before, after in (("unplanned", c0, c1), ("planned", c1, c2)):
        per = {k: after[k] - before[k] for k in ("rows_spgemm", "norms_and_keep")}
        print(f"[sym] {name} symmetric scan launches {per}")
        if per != {"rows_spgemm": steps, "norms_and_keep": steps}:
            raise AssertionError(f"{name} symmetric scan launches {per}")
    pg = sg.n_block_pairs
    for name, st in (("unplanned", su), ("planned", sp)):
        bad = {f: bool(getattr(st, f).any()) for f in (
            "pair_overflow", "out_overflow", "repack_overflow", "plan_mismatch")}
        ps = st.n_block_pairs
        print(f"[sym] {name}: pairs/step {ps.tolist()} vs generic {pg.tolist()}; kept "
              f"{st.nnz_blocks.tolist()}")
        if any(bad.values()) or not bool(((ps < pg) & (ps >= pg // 2)).all()):
            raise AssertionError(f"symmetric {name} scan: flags {bad}, pairs {ps.tolist()}")
    a64 = A.with_data(A.data.double())
    x64, _ = hbsm.purify_scan(a64, steps, tau, backend="xla", **kw)
    d64 = hbsm.to_dense(x64)
    dg = hbsm.to_dense(xg).double()
    for name, x in (("unplanned", xu), ("planned", xp)):
        d = hbsm.to_dense(x)
        if not torch.equal(d, d.T):
            raise AssertionError(f"symmetric {name} iterate is not exactly symmetric")
        e64, eg = rel_err(d.double(), d64), rel_err(d.double(), dg)
        print(f"[sym] {name} iterate: exactly symmetric; vs the float64 symmetric path rel err "
              f"{e64:.3e}, vs phase 7's iterate {eg:.3e}")
        if max(e64, eg) > 1e-5:
            raise AssertionError(f"symmetric {name} rel errs {e64:.3e}, {eg:.3e}")
    print(f"[sym] planned vs unplanned: ids equal {torch.equal(xp.ids, xu.ids)}, bitwise "
          f"{torch.equal(xp.data, xu.data)}, rel diff "
          f"{rel_err(hbsm.to_dense(xp), hbsm.to_dense(xu)):.3e}")
    # frob_block_trunc through the class at b = 128: one norms_and_keep.
    m = hbsm.HierarchicalBlockSparseMatrix.from_block_matrix(xp)
    cut = m.copy()
    cut.frob_block_trunc(1e-3)
    torch.cuda.synchronize()
    total = counts()
    if total["norms_and_keep"] - c2["norms_and_keep"] != 1:
        raise AssertionError("frob_block_trunc at b=128 did not run norms_and_keep once")
    want = hbsm.truncate(xp, 1e-3)
    if not torch.equal(cut.block_matrix.data, want.data) or m.get_nnz_blocks() != int(xp.nnz):
        raise AssertionError("frob_block_trunc at b=128 differs from truncate or leaks")
    print(f"[class] B3 symmetric iterate, frob_block_trunc(1e-3) on a copy: {int(xp.nnz)} -> "
          f"{cut.get_nnz_blocks()} blocks (1 norms_and_keep launch), equal to truncate")

    gkw = dict(target_trace=n / 2, **prof.kwargs())
    times = in_turns({
        "generic planned (phase 7)": lambda: hbsm.purify_scan(A, steps, tau, plans=plans, **gkw),
        "symmetric unplanned": lambda: hbsm.purify_scan(A, steps, tau, **kw),
        "symmetric planned": lambda: hbsm.purify_scan(A, steps, tau, plans=plans_s, **kw),
    })
    print(f"[time] {card}: B3 5-step scans, CUDA events, median of 7 after 2 warm-up calls, "
          f"in order then reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:26s} {t1:.3f} / {t2:.3f} ms")
    device_profile("planned symmetric B3 scan", lambda: hbsm.purify_scan(
        A, steps, tau, plans=plans_s, **kw), 10, card, unit="scan", top=8)
    return {k: total[k] for k in ("rows_spgemm", "norms_and_keep")}


def surface_phase(card, b1, b2, b3):
    """Phase 16: the class at B1 and B2, syrk and symmetric SP2 at B3.
    Returns the launches of the kernels on its paths."""
    import os

    import torch

    t0 = time.perf_counter()
    tmp_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase16")
    os.makedirs(tmp_dir, exist_ok=True)
    class_b1(card, b1)
    fine = class_b2(card, b2, tmp_dir)
    torch.cuda.empty_cache()
    A3, prof, plans, scan = b3
    syrk_rows = syrk_b3(card, A3)
    sym = symmetric_b3(card, A3, prof, plans, scan)
    out = {"fine_spgemm": fine, "rows_spgemm": syrk_rows + sym["rows_spgemm"],
           "norms_and_keep": sym["norms_and_keep"]}
    print(f"[phase16] {time.perf_counter() - t0:.1f} s; launches {out}")
    return out


def small_micro(card):
    """Phase 14: the four micro kernels vs their plain versions at small
    shapes: micro in every mode and tier at reps 0, 1 and 5, at shapes
    that cut the dot kernel's block tiles (32x32, 300x200, a ragged panel
    and 832 and 896 squares) and "quad" bitwise equal to "wide" at 896; the
    three e2 recipes; e3 bitwise, with indices past the last slot, below
    zero, all in one slot and none, and one e3 call read by its launch
    counter and by the profiler (one kernel, no sort); e12 at both tiers
    with and without the adds.  The [8, 128] output and the whole
    accumulator are both compared."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf
    from hierarchical_block_sparse_lib_tpu_torch.scripts.micro_fine_kernel import TOL as MICRO_TOL

    rng = np.random.default_rng(14)

    def normal(shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(DEVICE)

    def check(name, got, want, tol):
        torch.cuda.synchronize()
        err = max(rel_err(g, w) for g, w in zip(got, want))
        if not err <= tol:
            raise AssertionError(f"{name}: kernel vs plain rel err {err:.3e} > {tol}")
        print(f"  {name:34s} kernel-vs-plain rel err={err:.3e} (out and acc; tol {tol})")

    for mode, la, lb in (("wide", 32, 32), ("wide", 300, 200), ("wide", 256, 128),
                         ("wide", 832, 832), ("wide", 896, 896), ("quad", 256, 384),
                         ("quad", 896, 896), ("flatten", 128, 128)):
        at, bp = normal((32, la)), normal((32, lb))
        for prec in ("highest", "default"):
            for reps in (0, 1, 5):
                check(f"micro {mode} {la}x{lb} {prec} reps={reps}",
                      mf.micro(at, bp, mode, prec, reps=reps),
                      mf.micro_reference(at, bp, mode, prec, reps=reps), MICRO_TOL[prec])
    at, bp = normal((32, 896)), normal((32, 896))
    for prec in ("highest", "default"):
        wide, quad = mf.micro(at, bp, "wide", prec, reps=5)[1], mf.micro(at, bp, "quad", prec,
                                                                          reps=5)[1]
        if not torch.equal(wide, quad):
            raise AssertionError(f"micro quad differs from wide at 896 {prec}")
    print("  micro quad == wide bitwise at 896x896, both tiers")
    x = normal((32, 32), 1.0)
    for variant in mf.VARIANTS:
        if not torch.equal(mf.e2(x, variant), x.reshape(8, 128)):
            raise AssertionError(f"e2 {variant} differs from x.reshape(8, 128)")
    print(f"  e2 {', '.join(mf.VARIANTS)}: each equal to x.reshape(8, 128) bitwise")
    v = normal((8, 128), 1.0)
    for label, idx in (
        ("300 adds, indices up to 519 (past the last slot 511)", rng.integers(0, 520, 300)),
        ("4096 adds all into slot 7", np.full(4096, 7)),
        ("4097 adds, indices in [-600, 1100)", rng.integers(-600, 1100, 4097)),
        ("no adds", np.zeros(0)),
    ):
        idx = torch.from_numpy(idx.astype(np.int32)).to(DEVICE)
        got, want = mf.e3(idx, v), mf.e3_reference(idx, v)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"e3 differs from its plain version: {label}")
        print(f"  e3 {label}: equal to plain bitwise")
    e3_one_launch(mf, v, torch.from_numpy(rng.integers(0, 500, 4096).astype(np.int32)).to(DEVICE),
                  card)
    for ra, label, slots in (
        (5, "random slots", rng.integers(0, 512, 5 * 26)),
        (5, "all in slot 7", np.full(5 * 26, 7)),
        (5, "none in range", rng.choice([-3, 512, 900], 5 * 26)),
        # Past one scan chunk (4 096 entries), slots in and out of range.
        (320, "random slots past one scan chunk", rng.integers(-20, 530, 320 * 26)),
    ):
        a_wide, panel = normal((ra, 32, 128)), normal((8 * 26, 128))
        idx12 = torch.from_numpy(slots.astype(np.int32)).to(DEVICE)
        for prec in ("highest", "default"):
            for do_adds in (True, False):
                check(f"e12 RA={ra} {label} {prec} adds={do_adds}",
                      mf.e12(a_wide, panel, idx12, prec, do_adds),
                      mf.e12_reference(a_wide, panel, idx12, prec, do_adds), MICRO_TOL[prec])
    e12_one_launch(mf, a_wide, panel, idx12, card)


def e3_one_launch(mf, v, idx, card):
    """One e3 call at R3 = 4096: its launch counter must read 1, and the
    profiler over ten calls must list one device function, the e3 kernel
    (no sort or searchsorted, nor any other), launched at most once a call."""
    mf.e3.launches = 0
    mf.e3(idx, v)
    launches, mf.e3.launches = mf.e3.launches, 0
    dev = device_profile("e3 at R3=4096", lambda: mf.e3(idx, v), 10, card)
    mf.e3.launches = 0
    names = list(dev)
    if (launches != 1 or len(names) != 1 or "e3_kernel" not in names[0]
            or dev[names[0]][1] > 10):
        raise AssertionError(f"one e3 call: {launches} counted launches, device functions "
                             f"{dev}; expected 1 and the e3 kernel alone")
    print(f"  e3 one call at R3=4096: 1 counted launch; the profiler lists {names}")


def e12_one_launch(mf, a_wide, panel, idx, card):
    """One e12 call per tier: its launch counter must read 1, and the
    profiler over ten calls must list one device function, the e12 kernel
    (no sort or searchsorted, nor any other), launched once a call."""
    for prec in ("highest", "default"):
        mf.e12.launches = 0
        mf.e12(a_wide, panel, idx, prec)
        launches, mf.e12.launches = mf.e12.launches, 0
        dev = device_profile(f"e12 {prec}", lambda p=prec: mf.e12(a_wide, panel, idx, p), 10,
                             card)
        mf.e12.launches = 0
        names = list(dev)
        if (launches != 1 or len(names) != 1 or "e12_kernel" not in names[0]
                or dev[names[0]][1] > 10):
            raise AssertionError(f"one e12 {prec} call: {launches} counted launches, device "
                                 f"functions {dev}; expected 1 and the e12 kernel alone")
        print(f"  e12 {prec} one call: 1 counted launch; the profiler lists {names}")


def e12_yardstick(a_wide, panel, idx, nbrow, card):
    """e12's work as two library calls, TF32 off: one torch.bmm over the
    gathered (X_t, L_e) pairs and one index_add_ of the products into a
    zeroed accumulator (the gather is not timed).  A yardstick, not the
    same function: index_add_ keeps no order among a slot's adds."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf

    q = torch.arange(a_wide.shape[0] * nbrow, device=a_wide.device)
    x = panel.reshape(nbrow, 32, 32)[q % nbrow]
    lg = a_wide[:, :, 0:32][q // nbrow].contiguous()
    acc = torch.empty((mf.ACC_ROWS // 8, 1024), dtype=torch.float32, device=a_wide.device)
    slots = idx.long()

    def run():
        acc.zero_().index_add_(0, slots, torch.bmm(x, lg).reshape(-1, 1024))

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = cuda_time_ms(run)[0]
        us = per_call_us(device_profile("e12 yardstick (bmm + index_add_)", run, 10, card,
                                        top=3), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    print(f"[micro] e12 yardstick, torch.bmm over the {q.numel()} gathered pairs + index_add_ "
          f"(TF32 off): {ms:.4f} ms a call, {us:.1f} us of device time")


def micro_path(card, fine_ns_per_pair):
    """Phase 14: the three measurement scripts at their own shapes (each
    kernel against its plain version there, its times, bound and library
    time), with the micro kernels' launch counts read around the two micro
    scripts; then the profile of the B2 multiply in parts."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.scripts import micro_fine_kernel as m1
    from hierarchical_block_sparse_lib_tpu_torch.scripts import micro_fine_kernel2 as m2
    from hierarchical_block_sparse_lib_tpu_torch.scripts import profile_fine_pieces as pp

    torch.cuda.synchronize()
    reset_counts()
    recs = {**m1.main(DEVICE), **m2.main(DEVICE)}
    torch.cuda.synchronize()
    got = counts(MICRO_KERNELS)
    if min(got.values()) < 1:
        raise AssertionError(f"a micro kernel never launched on the scripts' path: {got}")
    print(f"[micro] {card}: the scripts at their shapes, CUDA events, median of 7 after 2 "
          f"warm-up calls, kernel, plain and library in turns (in order, then reversed); "
          f"launches {got}")
    for name, r in recs.items():
        if "four" not in r:  # a torch op
            print(f"[micro]   {name:24s} {r['ms']:.4f} ms, {r['nbytes'] / r['ms'] / 1e6:.0f} GB/s "
                  f"(bound {r['bound_ms']:.4f} ms)")
            continue
        k1, k2, p1, p2 = r["four"]
        lib = ("none" if r["library_two"] is None else
               f"{r['library_two'][0]:.4f} / {r['library_two'][1]:.4f} ms")
        print(f"[micro]   {name:24s} kernel {k1:.4f} / {k2:.4f} ms  plain {p1:.4f} / {p2:.4f} ms"
              f"  library {lib}  bound {r['bound_ms']:.5f} ms ({r['bound_by']})  "
              f"rel err {r['rel_err']:.2e}")
    sizes = m2.Sizes()
    n_leaf = sizes.RA * sizes.NBROW
    leaf_ns = recs["E12 highest adds=True"]["ms"] / n_leaf * 1e6
    print(f"[micro] e12 (highest, adds): {leaf_ns:.2f} ns per 32x32 leaf product per call; "
          f"the fine kernel at B2 (phase 5): {fine_ns_per_pair:.2f} ns per pair")
    # The wrapper times above include the host's launches; the device time
    # of each kernel alone, at the same shapes.
    from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf

    rng = np.random.default_rng(0)
    dev_us = {}

    def normal(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).to(DEVICE)

    at, bp = normal(32, m1.Sizes().LA), normal(32, m1.Sizes().LA)
    atq, bpq = normal(32, m1.Sizes().LAQ), normal(32, m1.Sizes().LAQ)
    a_wide, panel = normal(sizes.RA, 32, 128), normal(8 * sizes.NBROW, 128)
    idx = torch.from_numpy(rng.integers(0, 500, n_leaf).astype(np.int32)).to(DEVICE)
    for label, run, kernel, n in (
        ("micro wide highest", lambda: mf.micro(at, bp, "wide"), "dot_", None),
        ("micro quad highest", lambda: mf.micro(atq, bpq, "quad"), "dot_", None),
        ("micro wide default", lambda: mf.micro(at, bp, "wide", "default"), "dot_", None),
        ("micro quad default", lambda: mf.micro(atq, bpq, "quad", "default"), "dot_", None),
        ("e3 R3=4096", lambda: mf.e3(idx[:sizes.R3], panel[:8]), "e3_kernel", None),
        ("e12 highest adds", lambda: mf.e12(a_wide, panel, idx), "e12_kernel", n_leaf),
        ("e12 default adds", lambda: mf.e12(a_wide, panel, idx, "default"), "e12_kernel", n_leaf),
        ("e12 highest no adds", lambda: mf.e12(a_wide, panel, idx, do_adds=False),
         "e12_kernel", n_leaf),
    ):
        us = dev_us[label] = per_call_us(device_profile(label, run, 10, card, top=3), 10,
                                         kernel)
        per = f", {us * 1e3 / n:.2f} ns per leaf product" if n and us else ""
        if kernel == "dot_" and us:
            la = at.shape[1] if "wide" in label else atq.shape[1]
            hi = "highest" in label
            b_ms, _ = bound(2 * la * la * 32 * mf.REPS, 4 * 32 * 2 * la + 4 * la * la,
                            "fp32" if hi else "bf16")
            per = f", {100 * b_ms * 1e3 / us:.1f}% of its {b_ms:.4f} ms bound"
        print(f"[micro] {label}: {kernel} {us:.1f} us of device time per call{per}")
    # e12 at "highest" runs 3xTF32 on mma.sync: its route's bound and FP32's
    # (micro_fine_kernel2's flops and bytes).
    e12_bounds = tile_bounds(2 * 32**3 * n_leaf,
                             4 * (a_wide.shape[0] * 32 * 32 + panel.numel() + idx.numel())
                             + 4 * mf.ACC_ROWS * 128, dev_us["e12 highest adds"])
    print(f"[micro] e12 highest adds: bounds 3xTF32 {e12_bounds['bound_route_ms']:.5f} ms "
          f"({pct(e12_bounds['share_route'])}), FP32 {e12_bounds['bound_fp32_ms']:.5f} ms "
          f"({pct(e12_bounds['share_fp32'])}) of its device time per launch")
    e12_yardstick(a_wide, panel, idx, sizes.NBROW, card)
    for prec in ("highest", "default"):  # the library yardstick's device time
        dev = device_profile(f"stacked torch.matmul {prec}", m1.stacked_matmul(
            at, bp, mf.REPS, prec), 10, card, top=3)
        print(f"[micro] stacked torch.matmul {prec} at 832: {per_call_us(dev, 10):.1f} us of "
              f"device time per call")
    parts = pp.main(DEVICE)
    print(f"[B2 parts] {card}: " + ", ".join(
        f"{k} {v[0]:.4f} ms (spread {v[1]:.4f})" for k, v in parts.items()
        if isinstance(v, tuple)) + f"; {parts['pairs']} pairs")
    from hierarchical_block_sparse_lib_tpu_torch.scripts import time_fine_kernel as tf

    print(f"[fine] {card}: the kernel alone at B2's structure per leaf and tier "
          f"(scripts/time_fine_kernel.py, CUDA events, median of 7 after 2 warm-ups)")
    for key, r in tf.main(DEVICE).items():
        if key[0] == "sweep":
            _, leaf, tier, ctas, cs, n_win = key
            print(f"[fine]   sweep b={leaf} {tier}: {cs} slots per block, {n_win} column "
                  f"windows, sized for {ctas} per SM: "
                  + ("does not fit" if r is None else f"{r:.4f} ms"))
            continue
        (ms_b, by), ms = r["bound"], r["ms"]
        print(f"[fine]   b={key[0]:2d} {key[1]:8s} {ms:.4f} ms (spread {r['spread']:.4f}), "
              f"{r['pairs']} products, {r['ns_per_product_per_sm']:.1f} ns per product per "
              f"SM; bound {ms_b:.4f} ms ({by}), {100 * ms_b / ms:.1f}% of it; {r['config']}")
    picks ={"micro": "E1a wide highest", "e2": "E2x reshape", "e3": "E3",
             "e12": "E12 highest adds=True"}
    entries = {k: dict(max_abs_err=recs[n]["max_abs_err"], ms=recs[n]["ms"],
                       plain_ms=recs[n]["plain_ms"], library_ms=recs[n]["library_ms"],
                       bound=(recs[n]["bound_ms"], recs[n]["bound_by"]))
               for k, n in picks.items()}
    entries["e12"].update(e12_bounds)
    return entries, got


def spamm_b3(card, A):
    """Phase 17, SpAMM at B3's input: A @ A with tau halfway between two
    neighbouring pair-norm products near the median, on "rows" and "xla";
    pair and block counts against plan_spamm (C++ and numpy); "rows"
    against "xla"; the error against spamm_error_bound and an f64 product;
    one rows_spgemm launch per call; the kernel with its skip against its
    plain version; the planned SpAMM call beside the planned unfiltered
    one in turns; the kernel's device time against both bounds on the
    surviving pairs.  Returns its launches."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as rows
    from hierarchical_block_sparse_lib_tpu_torch.ops.norms import squared_threshold
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
        plan_spgemm_ex,
        spamm_error_bound,
    )
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    ids = A.ids.cpu().numpy()
    an = np.sqrt(hbsm.block_frob_squared(A).cpu().numpy())
    prods = np.sort(np.concatenate([p for _, _, p, _, _ in native._spamm_pairs(
        ids, an, ids, an, A.nb_cols, A.nb_cols)]))
    tau = gap_midpoint(prods, len(prods) // 2)
    pairs_f, out_f = hbsm.plan_spamm(A, A, tau)
    pairs_np = native.plan_spamm_numpy(ids, an, ids, an, A.nb_cols, A.nb_cols, tau)
    print(f"[spamm] B3 input A @ A: {pc} pairs, {oc} blocks; tau {tau:.6e} halfway between "
          f"pair-norm products {prods[prods < tau][-1]:.6e} and {prods[prods > tau][0]:.6e}; "
          f"plan_spamm {pairs_f} pairs ({100 * (1 - pairs_f / pc):.1f}% skipped), {out_f} blocks "
          f"(numpy {pairs_np})")
    if pairs_np != (pairs_f, out_f) or not 0 < pairs_f < pc:
        raise AssertionError(f"plan_spamm {pairs_f, out_f}, numpy {pairs_np}")
    kw = dict(pair_cap=pc, out_cap=out_f, gemm_cap=pairs_f, row_caps=(mbr, mcr))
    torch.cuda.synchronize()
    reset_counts()
    Cr, ir = hbsm.spamm(A, A, tau, backend="rows", **kw)
    torch.cuda.synchronize()
    got = launched({"rows_spgemm": 1, "block_frob_squared": 1}, "spamm on rows at B3")
    Cx, ix = hbsm.spamm(A, A, tau, backend="xla", **kw)
    for name, info in (("rows", ir), ("xla", ix)):
        if (int(info.n_block_pairs), int(info.n_out_blocks)) != (pairs_f, out_f) or flags_set(info):
            raise AssertionError(f"spamm {name}: {int(info.n_block_pairs)} pairs, "
                                 f"{int(info.n_out_blocks)} blocks, flags {flags_set(info)}")
    if not torch.equal(Cr.ids, Cx.ids):
        raise AssertionError("spamm rows and xla keep different blocks")
    err_rx = rel_err(Cr.data, Cx.data)
    d = hbsm.to_dense(A).double()
    exact = d @ d
    del d
    err_f = float(torch.linalg.norm(hbsm.to_dense(Cr).double() - exact))
    bound = spamm_error_bound(A, A, tau)
    norm = float(torch.linalg.norm(exact))
    del exact
    print(f"[spamm] rows vs xla rel err {err_rx:.3e}; ||C - A@A||_F {err_f:.6e} <= bound "
          f"{bound:.6e} + 1e-5 ||A@A||_F ({norm:.4e}); launches {got}")
    if err_rx > 1e-5 or err_f > bound + 1e-5 * norm:
        raise AssertionError(f"spamm rows vs xla {err_rx:.3e}, error {err_f:.3e} vs bound "
                             f"{bound:.3e}")
    n2 = hbsm.block_frob_squared(A)
    rargs = (A.ids, A.data, A.ids, A.data, Cr.ids, A.nb_rows, A.nb_rows, A.nb_cols, out_f, mbr, mcr)
    skip = dict(a_norms2=n2, b_norms2=n2, tau2=squared_threshold(tau))
    k = rows.rows_spgemm(*rargs, **skip)
    p = rows.rows_spgemm_reference(*rargs, **skip)
    k_err, rel = float((k - p).abs().max()), rel_err(k, p)
    print(f"[spamm] rows_spgemm with the skip vs plain at {pairs_f} of {pc} pairs: max abs err "
          f"{k_err:.3e}, rel {rel:.3e}")
    if rel > ROWS_TOL:
        raise AssertionError(f"spamm rows_spgemm rel err {rel:.3e}")
    plan_f = hbsm.make_plan(A, A, pc, tau=tau, filter_by_norm=True)
    plan_u = hbsm.make_plan(A, A, pc)
    times = in_turns({
        "spamm planned": lambda: hbsm.spamm(A, A, tau, backend="rows", plan=plan_f, **kw),
        "spgemm planned": lambda: hbsm.spgemm(A, A, pc, oc, backend="rows", plan=plan_u,
                                              row_caps=(mbr, mcr)),
    })
    for name, run in (("planned spamm", lambda: hbsm.spamm(A, A, tau, backend="rows",
                                                         plan=plan_f, **kw)),
                      ("planned unfiltered spgemm", lambda: hbsm.spgemm(
                          A, A, pc, oc, backend="rows", plan=plan_u, row_caps=(mbr, mcr)))):
        device_profile(f"{name} at B3 on rows", run, 10, card, top=4)
    dev = device_profile("rows_spgemm with the SpAMM skip at B3", lambda: rows.rows_spgemm(
        *rargs, **skip), 10, card, top=3)
    bnd = tile_bounds(2 * 128**3 * pairs_f, stored_bytes(A) + out_f * 128 * 128 * 4,
                      per_call_us(dev, 10, "rows_spgemm_kernel"))
    print(f"[time] {card}: SpAMM at B3, CUDA events, median of 7 after 2 warm-up calls, in "
          f"order then reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:16s} {t1:.4f} / {t2:.4f} ms")
    print(f"[time]   rows_spgemm with the skip: "
          + ("not measured" if bnd["device_ms"] is None else f"{1e3 * bnd['device_ms']:.1f} us")
          + f" per launch on {pairs_f} surviving pairs: bounds FP32 {bnd['bound_fp32_ms']:.4f} ms "
          f"({pct(bnd['share_fp32'])}), 3xTF32 {bnd['bound_route_ms']:.4f} ms "
          f"({pct(bnd['share_route'])})")
    return got


def gap_midpoint(sorted_values, m):
    """Halfway between the two neighbouring sorted values nearest index m
    that lie more than 1e-5 (relative) apart: a threshold no value lies
    near."""
    v = sorted_values
    for k in sorted(range(1, len(v)), key=lambda k: abs(k - m)):
        if v[k] > v[k - 1] * (1 + 1e-5):
            return float(0.5 * (v[k] + v[k - 1]))
    raise AssertionError("no gap between the values")


def aligned_b3(card, A):
    """Phase 17, the aligned accumulate at B3's input: C = A @ A + D with D
    on exactly the product's support, planned (make_plan(accum_ids=)) and
    planless on "rows", against the generic accumulate and f64; one
    rows_spgemm launch and no pass over the block data besides it; an
    accumulator that misses a product block flagged; times in turns.
    Returns its launches."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    kw = dict(backend="rows", row_caps=(mbr, mcr))
    C0, _ = hbsm.spgemm(A, A, pc, oc, **kw)
    gen = torch.Generator(device=A.device).manual_seed(17)
    noise = torch.randn(C0.data.shape, generator=gen, device=A.device)
    D = C0.with_data(torch.where(C0.valid_mask()[:, None, None], noise, 0))
    del C0, noise
    plan = hbsm.make_plan(A, A, pc, accum_ids=D.ids, out_cap=oc)
    aligned = dict(accum=D, accum_aligned=True, **kw)
    torch.cuda.synchronize()
    reset_counts()
    Ca, ia = hbsm.spgemm(A, A, pc, oc, plan=plan, **aligned)
    torch.cuda.synchronize()
    got = launched({"rows_spgemm": 1}, "aligned accumulate at B3")
    Cl, il = hbsm.spgemm(A, A, pc, oc, **aligned)
    Cg, ig = hbsm.spgemm(A, A, pc, oc, accum=D, **kw)
    for name, info in (("planned", ia), ("planless", il), ("generic", ig)):
        if flags_set(info):
            raise AssertionError(f"aligned accumulate ({name}) flags {flags_set(info)}")
    if not (torch.equal(Ca.ids, Cl.ids) and torch.equal(Ca.data, Cl.data)):
        raise AssertionError("planned and planless aligned calls differ")
    if not torch.equal(Ca.ids, Cg.ids):
        raise AssertionError("aligned and generic accumulates keep different blocks")
    d = hbsm.to_dense(A).double()
    exact = d @ d + hbsm.to_dense(D).double()
    del d
    err_g, err_x = rel_err(Ca.data, Cg.data), rel_err(hbsm.to_dense(Ca).double(), exact)
    del exact
    print(f"[aligned] B3 input, A @ A + D on the product's {oc} blocks: planned == planless "
          f"bitwise; vs generic rel err {err_g:.3e}, vs f64 {err_x:.3e}; launches {got}")
    if max(err_g, err_x) > 1e-5:
        raise AssertionError(f"aligned rel errs {err_g:.3e}, {err_x:.3e}")
    keep = torch.ones(D.cap, dtype=torch.bool, device=D.device)
    keep[oc // 2] = False
    Dn = hbsm.filter_blocks(D, keep)
    plan_n = hbsm.make_plan(A, A, pc, accum_ids=Dn.ids, out_cap=oc)
    flagged = [bool(hbsm.spgemm(A, A, pc, oc, plan=p, **dict(aligned, accum=Dn))[1].plan_mismatch)
               for p in (plan_n, None)]
    print(f"[aligned] an accumulator missing one product block: plan_mismatch planned "
          f"{flagged[0]}, planless {flagged[1]}")
    if not all(flagged):
        raise AssertionError(f"a product block outside the accumulator was not flagged: {flagged}")
    # The gather-add a generic accumulate runs reads and writes the block
    # data; any such pass takes at least one read of the accumulator at
    # the HBM rate.
    floor_us = stored_bytes(D) / 3.35e12 * 1e6
    big = {}
    for name, run in (("aligned", lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, **aligned)),
                      ("generic", lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, accum=D, **kw))):
        dev = device_profile(f"{name} accumulate at B3 (planned)", run, 10, card, top=6)
        big[name] = sorted((t / n, k) for k, (t, n) in dev.items()
                           if "rows_spgemm" not in k and n)[-1:] if dev else None
    print(f"[aligned] longest launch besides rows_spgemm: aligned {big['aligned']}, generic "
          f"{big['generic']} us; one read of the accumulator takes {floor_us:.1f} us")
    if big["aligned"] and big["aligned"][0][0] >= floor_us:
        raise AssertionError(f"the aligned call passes over block data: {big['aligned']}")
    times = in_turns({
        "aligned planned": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, **aligned),
        "generic planned": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, accum=D, **kw),
    })
    print(f"[time] {card}: accumulate at B3, CUDA events, median of 7 after 2 warm-up calls, "
          f"in order then reversed")
    for name, (t1, t2) in times.items():
        print(f"[time]   {name:16s} {t1:.4f} / {t2:.4f} ms")
    return got


def distinct_outputs(plan) -> int:
    """A plan's distinct output (or union) blocks."""
    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import first_of_run

    if plan.n_unique is not None:
        return int(plan.n_unique)
    return int((first_of_run(plan.c_id) & (plan.c_id != hbsm.SENTINEL)).sum())


def tight_caps(mul_plans, extra_out=()) -> tuple:
    """(pair_cap, out_cap) of a captured trajectory: the most surviving
    pairs of any of its products, and the most output blocks of any
    product, union or add (`extra_out`)."""
    return (max(int(p.total) for p in mul_plans),
            max([distinct_outputs(p) for p in mul_plans] + list(extra_out)))


def run_model(card, name, unplanned, planned, want_launches):
    """Launch counts around one unplanned and one planned call (each must
    be `want_launches`), planned == unplanned bitwise, no flag; the call
    time (CUDA events, median of 7 after 2 warm-ups) and a profile of the
    planned call.  Returns (result, launches of both calls)."""
    import torch

    total = {}
    out = []
    for label, run in (("unplanned", unplanned), ("planned", planned)):
        torch.cuda.synchronize()
        reset_counts()
        res = run()
        torch.cuda.synchronize()
        got = launched(want_launches, f"{name} ({label})")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        if bool(res[2]):
            raise AssertionError(f"{name} ({label}) overflow or plan drift flagged")
        out.append(res)
    (xu, pu, _), (xp, pp, _) = out
    if not (torch.equal(xu.ids, xp.ids) and torch.equal(xu.data, xp.data)) or int(pu) != int(pp):
        raise AssertionError(f"{name}: planned and unplanned differ")
    times = {label: cuda_time_ms(run)[0] for label, run in (("unplanned", unplanned),
                                                             ("planned", planned))}
    print(f"[models] {name}: {int(pu)} block pairs; planned == unplanned bitwise; launches per "
          f"call {want_launches}; {card}: call unplanned {times['unplanned']:.3f} ms, planned "
          f"{times['planned']:.3f} ms (CUDA events, median of 7 after 2 warm-ups)")
    device_profile(f"planned {name}", planned, 3, card, top=6)
    return xp, total


def models_b3(card, A):
    """Phase 17, the three model drivers at B3's size (4096^2, b = 128),
    each unplanned, then planned (bitwise equal), against an f64 oracle:
    polynomial (the pair-stream kernel: no row caps), chebyshev_apply
    with gershgorin_bound's scaling and Newton-Schulz (both on the
    row-panel kernel).  The caps are the trajectories' own, read from a
    plan walk at the dense bounds.  Returns the launches."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch import models

    n, b, tau, nb = A.n_rows, A.block_size, 1e-6, A.nb_rows
    loose = (nb**3, nb * nb)
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # Horner.
    coeffs = [0.5, -1.0, 0.25, 2.0]
    pc, oc = tight_caps(models.plan_polynomial(A, coeffs, tau, *loose).mul_plans)
    hp = models.plan_polynomial(A, coeffs, tau, pc, oc)
    steps = len(coeffs) - 1
    P, got = run_model(
        card, f"polynomial (caps {pc}, {oc})",
        lambda: models.polynomial(A, coeffs, tau, pc, oc),
        lambda: models.polynomial(A, coeffs, tau, pc, oc, plans=hp),
        {"gather_gemm_accumulate_stream": steps, "norms_and_keep": steps})
    add(got)
    d = hbsm.to_dense(A).double()
    eye = torch.eye(n, dtype=torch.float64, device=d.device)
    want = 0.5 * eye - d + 0.25 * (d @ d) + 2.0 * (d @ d @ d)
    err = rel_err(hbsm.to_dense(P).double(), want)
    print(f"[models] polynomial [0.5, -1, 0.25, 2] at tau {tau}: vs f64 dense Horner rel err "
          f"{err:.3e} (to max)")
    if err > 1e-5:
        raise AssertionError(f"polynomial rel err {err:.3e}")
    del P, want

    # Chebyshev: H = A / gershgorin_bound(A).
    g = float(hbsm.gershgorin_bound(A))
    g64 = float(d.abs().sum(1).max())
    print(f"[models] gershgorin_bound {g:.8f}, f64 row sums {g64:.8f} (rel {abs(g / g64 - 1):.2e})")
    if abs(g / g64 - 1) > 1e-6:
        raise AssertionError("gershgorin_bound differs from the f64 row sums")
    H = hbsm.scale(A, 1.0 / g)
    fermi = lambda x: 1.0 / (1.0 + np.exp(6.0 * x))  # noqa: E731
    c = models.chebyshev_coeffs(fermi, 24)
    rc = (nb, nb)
    cp = models.plan_chebyshev(H, len(c), tau, *loose, row_caps=rc)
    pc, oc = tight_caps(cp.mul_plans, [int(p.nnz) for p in cp.add_plans])
    cp = models.plan_chebyshev(H, len(c), tau, pc, oc, row_caps=rc)
    terms = len(c) - 2
    F, got = run_model(
        card, f"chebyshev_apply, 25 terms (caps {pc}, {oc})",
        lambda: models.chebyshev_apply(H, c, tau, pc, oc, row_caps=rc),
        lambda: models.chebyshev_apply(H, c, tau, pc, oc, row_caps=rc, plans=cp),
        {"rows_spgemm": terms, "norms_and_keep": terms})
    add(got)
    w, V = torch.linalg.eigh(hbsm.to_dense(H).double())
    want = (V * torch.from_numpy(fermi(w.cpu().numpy())).to(V.device)) @ V.T
    err = float((hbsm.to_dense(F).double() - want).abs().max())
    print(f"[models] chebyshev Fermi (beta 6), spectrum [{float(w[0]):.4f}, {float(w[-1]):.4f}]: "
          f"vs f64 eigendecomposition max abs err {err:.3e}")
    if err >= 1e-4:
        raise AssertionError(f"chebyshev max abs err {err:.3e}")
    del F, want, V, H

    # Newton-Schulz on S = I + a symmetric band (tests/test_models.py's
    # construction at 4096^2), scaled to spectrum [0.5, 1.5].
    rng = np.random.default_rng(4)
    m = torch.zeros((n, n), dtype=torch.float64, device=d.device)
    for k in range(1, 4):
        v = torch.from_numpy(rng.standard_normal(n - k) * 0.05).to(d.device)
        m += torch.diag(v, k) + torch.diag(v, -k)
    lam_m = torch.linalg.eigvalsh(m)
    scale = 0.5 / float(lam_m.abs().max())
    S_d = (eye + scale * m).float()
    S = hbsm.from_dense(S_d, block_size=b)
    lam = 1 + scale * lam_m
    theta = 1.1 * float(lam[-1])
    cap_plans = models.plan_inv_sqrt(S, theta, 25, tau, *loose, row_caps=rc)
    pc, oc = tight_caps(cap_plans.p_zy + cap_plans.p_t + cap_plans.p_z2)
    nsp = models.plan_inv_sqrt(S, theta, 25, tau, pc, oc, row_caps=rc)
    Z, got = run_model(
        card, f"inv_sqrt_newton_schulz, 25 steps (caps {pc}, {oc})",
        lambda: models.inv_sqrt_newton_schulz(S, theta, 25, tau, pc, oc, row_caps=rc),
        lambda: models.inv_sqrt_newton_schulz(S, theta, 25, tau, pc, oc, row_caps=rc,
                                              plans=nsp),
        {"rows_spgemm": 75, "norms_and_keep": 25})
    add(got)
    zd = hbsm.to_dense(Z).double()
    r = zd.T @ S_d.double() @ zd - eye
    err, fro = float(r.abs().max()), float(torch.linalg.norm(r))
    print(f"[models] Newton-Schulz S = I + band (spectrum [{float(lam[0]):.4f}, "
          f"{float(lam[-1]):.4f}], theta {theta:.4f}, {int(Z.nnz)} blocks kept): "
          f"max|Z^T S Z - I| {err:.3e}, ||Z^T S Z - I||_F {fro:.3e}")
    if err >= 1e-4:
        raise AssertionError(f"Newton-Schulz max abs err {err:.3e}")
    return launches


def subtree_b3(A, prof):
    """Phase 17, subtree truncation at level 3 on B3's step-1 product
    against a host f64 computation of the level-3 node norms (same kept
    ids), and frob_norm and nnz_blocks against the host.  Returns its
    launches."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm

    n, tau, level = A.n_rows, 1e-6, 3
    x1, _ = hbsm.purify_scan(A, 1, tau, target_trace=n / 2, **prof.kwargs())
    A2, info = hbsm.spgemm(x1, x1, prof.pair_cap, prof.out_cap, row_caps=prof.row_caps)
    ids = A2.ids.cpu().numpy().astype(np.int64)
    valid = ids != hbsm.SENTINEL
    blocks2 = A2.data.double().square().sum((1, 2)).cpu().numpy()
    depth = int(A2.nb_rows - 1).bit_length()
    shift = depth - level
    node = (ids // A2.nb_cols >> shift) * 2**level + (ids % A2.nb_cols >> shift)
    node_norm = {}
    for k, v in zip(node[valid], blocks2[valid]):
        node_norm[k] = node_norm.get(k, 0.0) + v
    norms = np.sort(np.sqrt(np.array(list(node_norm.values()))))
    tau_s = gap_midpoint(norms, len(norms) // 2)
    want = ids[valid & np.array([node_norm.get(k, 0.0) ** 0.5 > tau_s for k in node])]
    torch.cuda.synchronize()
    reset_counts()
    T = hbsm.truncate(A2, tau_s, subtree_level=level)
    torch.cuda.synchronize()
    got = launched({"block_frob_squared": 1}, "subtree truncate")
    kept = T.ids.cpu().numpy()[: int(T.nnz)]
    print(f"[subtree] B3 step-1 product ({int(info.n_block_pairs)} pairs, {int(A2.nnz)} blocks): "
          f"{len(node_norm)} level-{level} nodes; tau {tau_s:.6e}; kept {len(kept)} blocks, "
          f"host f64 {len(want)}, ids equal {np.array_equal(kept, want)}; launches {got}")
    if not np.array_equal(kept, want):
        raise AssertionError("subtree truncation keeps other blocks than the host")
    fro, fro64 = float(hbsm.frob_norm(A2)), float(np.sqrt(blocks2.sum()))
    print(f"[subtree] frob_norm {fro:.8f} vs host {fro64:.8f}; nnz_blocks "
          f"{int(hbsm.nnz_blocks(A2))} vs host {int(valid.sum())}")
    if abs(fro / fro64 - 1) > 1e-6 or int(hbsm.nnz_blocks(A2)) != int(valid.sum()):
        raise AssertionError("frob_norm or nnz_blocks differ from the host")
    return got


def demo_1024():
    """Phase 17, scripts/purification_demo.py at n = 1024 in this process:
    within its own tolerance of the spectral projector.  Returns its
    launches."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.scripts import purification_demo

    torch.cuda.synchronize()
    reset_counts()
    err = purification_demo.main(["1024"])
    torch.cuda.synchronize()
    got = {k: v for k, v in counts(KERNELS).items() if v}
    print(f"[demo] purification_demo 1024: rel err {err:.3e} (tolerance "
          f"{purification_demo.TOL:.0e}); launches {got}")
    if not err <= purification_demo.TOL:
        raise AssertionError(f"purification demo rel err {err:.3e}")
    return got


def models_phase(card, b3):
    """Phase 17: SpAMM, the aligned accumulate, the three model drivers and
    subtree truncation at B3's size, then the demo.  Returns the launches
    of the kernels on its paths."""
    import torch

    t0 = time.perf_counter()
    A, prof, _, _ = b3
    total, secs = {}, {}
    parts = (("spamm", lambda: spamm_b3(card, A)), ("aligned", lambda: aligned_b3(card, A)),
             ("models", lambda: models_b3(card, A)), ("subtree", lambda: subtree_b3(A, prof)),
             ("demo", demo_1024))
    for name, part in parts:
        t1 = time.perf_counter()
        for k, v in part().items():
            total[k] = total.get(k, 0) + v
        torch.cuda.empty_cache()
        secs[name] = round(time.perf_counter() - t1, 1)
    print(f"[phase17] {time.perf_counter() - t0:.1f} s ({secs}); launches {total}")
    return total


def main() -> int:
    import torch

    script_t0 = time.perf_counter()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    card = card_line()
    print(card)

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import _build
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
        fine_spgemm,
        fine_spgemm_reference,
    )
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import (
        random_block_matrix,
    )

    # Phase 2: build, one nvcc per source, all started together.
    t0 = time.perf_counter()
    _build.load_all(["gemm_fine", "gemm_rows", "norms", "gemm_stream", "gemm_groups",
                     "micro_fine"])
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s")
    for name, (secs, log) in sorted(_build.build_logs.items()):
        print(f"[build] nvcc {name}: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {line.strip()}")
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import launch_config

    for b in (16, 32, 64):  # at B2's B row cap, 44
        for prec in ("highest", "high", "default"):
            print(f"[build] fine_spgemm b={b} {prec}: {launch_config(b, prec, 44)}")
    tile_kernel_report()

    # Phase 3: kernels vs plain versions at small shapes.
    print("[small] kernel vs plain version")
    small_shapes()
    small_rows()
    small_norms()
    small_stream()
    small_ring_edges()
    small_groups()

    # Phase 4: the B2 path at its configured size.
    n, b, density, seed = 16384, 32, 0.05, 2
    A = random_block_matrix(n, b, density, seed=seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    Af = hbsm.fine_pack(A)
    plan = hbsm.make_fine_plan(Af, Af, pc, oc, (mbr, mcr))
    C, info = hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan)
    D = hbsm.fine_unpack(hbsm.fine_scale(hbsm.fine_add(C, Af, beta=0.25), 2.0))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    fine_launches = fine_spgemm.launches
    print(f"[B2] {n}^2 b={b} density={density} seed={seed}: {int(A.nnz)} blocks, "
          f"pairs={pc} out_blocks={oc} row caps=({mbr}, {mcr}); "
          f"chain {main_s:.3f} s (first call), kernel launches={fine_launches}")
    if fine_launches < 1:
        raise AssertionError("the B2 path did not launch the fine kernel")
    flags = {k: bool(getattr(info, k)) for k in (
        "pair_overflow", "out_overflow", "row_overflow", "plan_mismatch")}
    if any(flags.values()):
        raise AssertionError(f"flags set: {flags}")
    if (int(info.n_block_pairs), int(info.n_out_blocks)) != (pc, oc):
        raise AssertionError(
            f"counters {int(info.n_block_pairs)}, {int(info.n_out_blocks)} "
            f"!= host plan {pc}, {oc}"
        )
    dA = hbsm.to_dense(A).double()
    exact = 2.0 * (0.5 * torch.matmul(dA, dA) + 0.25 * dA)
    rel = float(
        (hbsm.to_dense(D).double() - exact).abs().max() / exact.abs().max()
    )
    del dA, exact, D
    print(f"[B2] chain vs f64 oracle: max rel err {rel:.3e} "
          f"(a block per slot, the design replaced: 1.6e-7)")
    if rel > 1e-5:
        raise AssertionError(f"B2 chain rel err {rel:.3e} > 1e-5")

    # Phase 5: the fine kernel vs plain at B2's shapes; determinism; times.
    args = (Af.ids, Af.data, Af.ids, Af.data, plan.out_ids, Af.nb_rows,
            Af.nb_rows, Af.nb_cols, oc, mbr, mcr)
    kw = dict(block_size=b, out_layout="flat", alpha=0.5, tables=plan.tables)
    plain = fine_spgemm_reference(*args, **kw)
    fine_err = check_close("B2 kernel vs plain", C.data, plain, TOL["highest"])
    del plain
    print(f"[B2] kernel vs plain version: max abs err {fine_err:.3e} "
          f"(rtol = atol = {TOL['highest']})")
    C2, _ = hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan)
    if not torch.equal(C.data, C2.data):
        raise AssertionError("repeated planned fine_matmul is not bitwise equal")
    del C2, C
    print("[B2] repeated planned fine_matmul: bitwise equal")
    fine_ms, fine_plain_ms, four = alternate(
        lambda: hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan),
        lambda: fine_spgemm_reference(*args, **kw),
    )
    flops = 2 * b**3 * pc
    print(f"[time] {card}: planned fine_matmul at B2 (highest), median of 7, "
          f"in turns plain, kernel, kernel, plain")
    print(f"[time]   kernel {four[0]:.3f} / {four[1]:.3f} ms  "
          f"-> {flops / fine_ms / 1e6:.1f} GFLOP/s")
    print(f"[time]   plain  {four[2]:.3f} / {four[3]:.3f} ms  "
          f"-> {flops / fine_plain_ms / 1e6:.1f} GFLOP/s")
    fine_bound = bound(flops, 2 * Af.data.numel() * 4 + oc * b * b * 4)
    fine_ns_per_pair = fine_ms / pc * 1e6
    b2 = (A, Af, plan, pc, oc, (mbr, mcr))  # phase 15's kpack and spmm (0.1 GB)
    del Af, plan, A
    torch.cuda.empty_cache()

    # Phase 6: the graft entry's step.
    graft_step()

    # Phases 7 and 8: the B3 path, then its kernels alone and the times.
    A3, prof, plans, b3_launches, b3_scan = b3_path()
    entries, _ = b3_kernels_and_times(A3, prof, plans, card)

    # Phase 9: purification against the spectral projector.
    acceptance_purification()

    # Phase 10: profile of the planned B3 scan.
    profile_planned_b3(A3, prof, plans, card)

    # Phase 11: B3's input through purify, on the pair-stream kernel.
    purify_launches = purify_b3(A3, prof, b3_scan)
    b3 = (A3, prof, plans, b3_scan)  # phase 16's syrk and symmetric scans (0.1 GB)
    del A3, prof, plans, b3_scan
    torch.cuda.empty_cache()

    # Phases 12 and 13: B1 on the row-group kernel; B2-tile128 on the
    # pair-stream kernel and the v1 call.
    entries["groups_spgemm"], b1_launches, b1 = b1_path(card)
    stream_entries, b2t_launches, v1_launches = b2_tile128(card)
    entries.update(stream_entries)

    # Phase 15: the occupancy tiers and B4 (B3's and B2-tile128's tensors
    # are freed by now).
    b4_rows, b4_groups = occupancy_phase(card, b1, b2)

    # Phase 16: the class at B1 and B2, syrk and symmetric SP2 at B3.
    p16 = surface_phase(card, b1, b2, b3)
    del b1, b2
    torch.cuda.empty_cache()

    # Phase 17: SpAMM, the aligned accumulate, the model drivers and
    # subtree truncation at B3's size, and the purification demo.
    p17 = models_phase(card, b3)
    del b3
    torch.cuda.empty_cache()

    # Phase 14: the micro kernels at small shapes, then the measurement
    # scripts at their shapes and the B2 multiply in parts.
    print("[small] micro kernels vs plain versions")
    small_micro(card)
    micro_entries, micro_launches = micro_path(card, fine_ns_per_pair)
    entries.update(micro_entries)
    print(f"[mem] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    entries["fine_spgemm"] = dict(
        max_abs_err=fine_err, ms=fine_ms, plain_ms=fine_plain_ms,
        bound=fine_bound, library_ms=None,
    )
    launches = dict(
        b3_launches, fine_spgemm=fine_launches, groups_spgemm=b1_launches + b4_groups,
        gather_gemm_accumulate_stream=b2t_launches + purify_launches,
        gather_gemm_accumulate=v1_launches, **micro_launches,
    )
    launches["rows_spgemm"] += b4_rows
    for name, n16 in p16.items():
        launches[name] += n16
    for name, n17 in p17.items():
        launches[name] += n17
    print(f"[launches] gather_gemm_accumulate_stream: {b2t_launches} on B2-tile128 + "
          f"{purify_launches} in purify on B3; rows_spgemm: {b3_launches['rows_spgemm']} on "
          f"B3 + {b4_rows} on B4 (phase 15) + {p16['rows_spgemm']} with triu (phase 16: syrk "
          f"and the symmetric B3 path); norms_and_keep: {b3_launches['norms_and_keep']} on B3 "
          f"+ {p16['norms_and_keep']} (phase 16); fine_spgemm: {fine_launches} on B2 + "
          f"{p16['fine_spgemm']} through the class (phase 16); phase 17 (SpAMM, aligned, "
          f"models, subtree, demo): {p17}")
    print(f"[time] script wall {time.perf_counter() - script_t0:.1f} s")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on its path: {launches}")
    rows_out = []
    for name, (source, replaces) in KERNELS.items():
        e = entries[name]
        rows_out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
            "bound_by": e["bound"][1], "library_ms": e["library_ms"],
            # The tensor-core kernels: both bounds and the kernel's share of each.
            **{k: e[k] for k in ("bound_fp32_ms", "bound_route", "bound_route_ms",
                                 "device_ms", "share_fp32", "share_route") if k in e},
        })
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
