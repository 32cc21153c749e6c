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
   kernels must have, and the fine kernel's "highest" instantiations at
   b = 32 (3xTF32 mma.sync, both launch shapes) too, FFMA at b = 16 and
   64, each shape with no spill and the blocks per SM it is sized for;
3. each kernel vs its plain PyTorch version at small shapes: the fine
   kernel at b in {16, 32, 64} x the three precision tiers (rectangular
   alpha != 1 operands with empty rows, the zero tail), then its edges at
   each leaf x tier x both layouts x the B row seen whole and capped at
   8 (at b = 32 "highest" in both launch shapes): an A row longer than a
   shared-memory k-chunk, a C row cut by a chunk boundary, an empty A row with output slots that no product
   reaches, an empty C row, slots with one and with many products, a
   SENTINEL tail; the row-panel kernel at b=128 (256 and 384 in phase 21) x the three tiers, bf16 data, the
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
   determinism of a repeated planned multiply, and CUDA-event times; the
   kernel's profiler device time a launch and its share of the 3xTF32
   bound, beside the FFMA design's;
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
   yardstick; block_frob_squared's device time per launch against its
   bound;
9. purification at 1024^2 (tau=1e-7, 40 steps) against the spectral
   projector from an f64 eigendecomposition: the port's acceptance check
   `scripts/acceptance.py::b3_purification`;
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
    scripts/purification_demo.py at 1024^2 against its tolerance;
18. (run last, after phase 14) the distributed path (parallel/) on 8 logical
    shards (on one card all share it and the collectives pass
    references; on several cards they spread in contiguous groups):
    entry.dryrun_multichip(8) at tiny shapes, then B5 at its configured
    size (BASELINE.json config 5: 131072^2, leaf 128, block band + 0.2%
    random blocks, seed 7): plan_route against the JAX package's numbers
    (25 869 pairs, per-device pairs, 8 176 routed against 36 078 ring
    blocks), dist_spgemm_routed planned, frozen (bitwise equal to
    planned) and frozen aligned, the ring and the single-device product,
    each against the f64 single-device product; two-level routing at 2 x
    4 and 4 x 2 against the JAX package's traffic; one frozen routed SP2
    step (55 090 pairs, 41 882 kept blocks) against the single-device
    sp2_step; Cannon at 2 x 2 on a B5 mix of 256 block rows; every
    call's launches counted and its flags clean; the frozen routed call
    under no host sync, the blocks moved per exchange, times in turns and
    a profile of the routed call (one card), and the peak memory;
19. (run after phase 18) the port's two entry points: its acceptance
    checks (scripts/acceptance.py: seven checks at full size against f64
    oracles) in this process, then its bench (bench.py's nine stages and
    headline) in a subprocess, as a user runs it: exit 0, the headline line
    with bench.py's four keys and finite positive numbers, every stage's
    backend, the counters against the JAX package's plans, and the stage
    table (CUDA events; no profiler);
20. (run after phase 19) the eight ablation scripts, each in a subprocess
    as a user runs it (python -m hierarchical_block_sparse_lib_tpu_torch.
    scripts.<name>): profile_b3 (one SP2 step at B3 in parts),
    profile_scan (the planned scan's fixed costs at 6144^2, and the
    compaction two ways), bench_symmetric (generic against symmetric
    planned SP2 at B3-scale and 6144^2), profile_routed_1dev (the routed
    one-shard product at B2-tile128 in parts, the aligned and generic
    later-stage accumulates), bench_scatter_accum (the gather-add against
    the in-place scatter-add at B2's routed-stage shapes), bench_band_route
    (B1's leaf-16 product through the band tier against the block path),
    bench_planner_scaling (the route planners' host time at 2 ... 64
    shards) and b5_route2_evidence (two-level traffic on B5's full grid
    and the 4x2 anchor against f64): exit 0, every check passed, the
    kernels of each path launched, the counters against the JAX
    package's (B3's profile, B2-tile128's, the symmetric pairs, the
    planners' traffic, docs/B5_ROUTE.md's table), and one table of each
    part's call time, device time and launches;
21. (run after phase 20, in its own process: ``python3 chip_smoke.py
    --phase21`` runs it alone) the row-panel kernel at leaves wider than
    128: (a) against its plain version at b = 256 and 384 on phase 3's
    small shapes (three tiers, bf16, the SpAMM skip, triu, the aligned
    accumulator, union slots and a tail), and b = 192 refused on the card;
    (b) B4 at leaf 256 (random_block_matrix(8192, 256, 0.5, seed=4), the
    same 275 GFLOP as B4 at 128): the planned spgemm with row caps (auto
    -> "rows") against the stream kernel's product and f64, spamm (tau at
    the median pair-norm product), syrk (triu) and the aligned accumulate
    through their public calls, one rows_spgemm launch each, the kernel
    with the skip and with triu against its plain version, and the
    planned product in turns with B4 at leaf 128, device time per launch
    against both bounds; (c) B4full at leaf 256 (32768², 8 slabs) through
    spgemm_colslab against f64 one slab of columns at a time, the call's
    time and the device time per slab launch against both bounds; (d) B5
    at leaf 256 (b5_mix(512, 256, seed=7), 131072²) on 8 logical shards:
    the frozen plan's aligned decision, the frozen aligned and generic
    routed products and the single-device product against each other and
    an f64 oracle on 64 sampled blocks, their call times in turns, device
    time and launches per call;
22. (run after phase 21, in its own process: ``python3 chip_smoke.py
    --phase22`` runs it alone) the members the surface walk of
    tests/test_torch_surface.py requires: BlockMatrix.block_rows,
    block_cols, make_id and density of B2's A (16384^2, leaf 32, 13 107
    blocks) and of B4 at leaf 256, each also with padding slots, computed on
    the card with no host sync and held equal to numpy's from the host
    copy of the ids (density bitwise, also on a 2 x 3 grid of 5 blocks,
    whose count a reciprocal would round differently); FineFlat.fr of B2
    (8).  It launches no kernel;
23. (run after phase 22, in its own process: ``python3 chip_smoke.py
    --phase23`` runs it alone) the union-add kernel at the B2 chain's add
    (C = 0.5 A.A from the planned fine product, then C + 0.25 A): bit for
    bit equal to its plain version and to the former add (concatenate,
    compact_sorted); call times in turns with both; device time of the
    slot pass and of the block pass against the block pass's byte bound;
    device operations a call against the former add's;
24. (run after phase 23, in its own process: ``python3 chip_smoke.py
    --phase24`` runs it alone) spgemm's fine-branch output pass at the
    b3_sp2.planned step's capacities (262 144 slots of 32 x 32, alpha -1
    and beta 2 on the card): bit for bit equal to its plain version and to
    the former passes (transpose, ×alpha where, gather, ×beta add); call
    times in turns with the plain version; device time of the pass and of
    its slot map against the pass's byte bound; device operations a call;
25. (run after phase 24, in its own process: ``python3 chip_smoke.py
    --phase25`` runs it alone) the truncation's two passes at the
    b3_sp2.planned step's capacities (262 144 slots of 32 x 32, 172 000
    valid, cap 65 536): given the same keep, bit for bit the plain
    compaction; the keep decisions that differ from the former chain's
    (torch reductions, cumsum, scatter, gather), each within rounding of
    tau^2; call times in turns with the former chain; device time of each
    pass against their byte bound; device operations a call, the former
    chain's beside them;
26. (run after phase 25, in its own process: ``python3 chip_smoke.py
    --phase26`` runs it alone) the fine kernel at the B3 cells' products:
    an SP2 X.X step (832^2 grid, X banded with ~34 blocks a row) and a
    Newton-Schulz Z.T step (416^2, Z with ~137 blocks a row, T dense) at the
    cells' capacities and row caps, where `launch_shape` must pick the
    narrow shape (windows of 52 and 7 columns, A rows longer than its
    k-chunk): one counted launch each against the plain version at
    TOL["highest"], SENTINEL slots zero, the wide shape bitwise equal, and
    both shapes' CUDA-event times in turns.

Every add on the card launches the union-add kernel once, so each path's
exact launch check counts it too (phase 4's chain 1, syrk 1, the ring and
Cannon one a shard a stage, the routed SP2 step one a shard, chebyshev
one a term unplanned and one planned), and the JSON line's count of it,
as of every kernel, is the sum of the checked paths' counts.  Every
spgemm on the fine backend launches the output pass once (the class's two
B2 multiplies in phase 16, the acceptance's fine-branch products).  Every
truncation on the card launches the truncate kernels' two passes; at
128-wide f32 and bf16 leaves it also launches norms_and_keep once, and
each such path's check names both counts.

Phase 2 also prints each fine-kernel launch's k-chunk, shared memory,
occupancy, registers and spills at B2's B row cap.  Prints the card line
and one JSON line of per-kernel results, then, as
the last line, ``{"ok": true, "device": {...}}``.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
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
    device_profile,
    in_turns,
    per_call_us,
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
    "union_add": (_CSRC + "union_add.cu", "none: the JAX package's add is plain XLA"),
    "fine_epilogue": (_CSRC + "fine_epilogue.cu",
                      "none: the JAX package applies alpha and the accumulate in XLA"),
    "truncate": (_CSRC + "truncate.cu", "none: the JAX package truncates in jnp"),
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
# B5 (BASELINE.json config 5: 131072^2, leaf 128, block band + 0.2% random
# blocks, seed 7) over 8 shards as the JAX package plans and runs it on its
# 8-device mesh (docs/B5_ROUTE.md, scripts/b5_route_evidence.py,
# b5_route_full.py, b5_route2_evidence.py).  route2: (hosts, chips) ->
# (inter-host blocks, the flat plan's inter-host blocks, intra-host blocks).
B5 = dict(
    nb=1024, nnz=5154, pairs=25869, out_blocks=19548,
    per_device_pairs=(3023, 3338, 3132, 3365, 3169, 3173, 3421, 3248),
    per_stage_blocks=(5154, 1231, 1214, 1149, 1136, 1103, 1193, 1150),
    blocks_routed=8176, blocks_ring=36078, sp2_pairs=55090, sp2_kept=41882,
    route2={(2, 4): (3340, 4627, 25482), (4, 2): (6266, 7054, 11420)},
)
# Distributed products against their single-device oracle, relative to
# max|C|.
DIST_TOL = 1e-5
DEVICE = "cuda"
# Phase 15's leaf-128 B4full device time, reported beside phase 21's leaf 256.
LEAF128 = {}


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
    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import run_slots

    a_idx, b_idx, c_id, _, _ = hbsm.spgemm_symbolic(A, B, pair_cap)
    return a_idx, b_idx, run_slots(c_id, out_cap)[0].to(torch.int32)


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


def fine_kernel_report():
    """Phase 2: the fine kernel's "highest" product runs on the tensor
    cores at b = 32 (3xTF32 mma.sync: HMMA in both shapes'
    `fine_spgemm_kernel<32, 3, threads>`) and FP32 FFMA at b = 16 and 64,
    where 3xTF32 measured slower (FFMA in `fine_spgemm_kernel<b, 0, 256>`);
    every shape `launch_shape` picks at "highest" with no spill and the
    blocks per SM its shared memory is sized for."""
    import re

    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf

    tiers = {0: "highest FFMA", 1: "high", 2: "default", 3: "highest 3xTF32"}
    seen = set()
    for fn, (hmma, _, ffma) in sass_counts("gemm_fine").items():
        m = re.search(r"fine_spgemm_kernelILi(\d+)ELi(\d)ELi(\d+)E", fn)
        if m is None:
            continue
        b, mode, threads = (int(x) for x in m.groups())
        print(f"[build] SASS fine_spgemm_kernel<{b}, {mode}, {threads}> {tiers[mode]:14s}: "
              f"{hmma:4d} HMMA {ffma:5d} FFMA")
        if mode in (0, 3):
            seen.add((b, threads))
            if (hmma if mode == 3 else ffma) == 0:
                raise AssertionError(f"fine_spgemm_kernel<{b}, {mode}, {threads}>: no "
                                     f"{'HMMA' if mode == 3 else 'FFMA'} in its SASS")
            if (mode == 3) != (b == 32):
                raise AssertionError(f"fine_spgemm_kernel<{b}, {mode}, {threads}>: "
                                     f"\"highest\" runs 3xTF32 at b = 32 and FFMA elsewhere")
    want = {(b, threads) for b in (16, 32, 64) for threads, _ in pf.shapes(b, "highest")}
    if seen != want:
        raise AssertionError(f"fine_spgemm_kernel \"highest\" instantiations: {sorted(seen)}")
    for b in (16, 32, 64):
        for threads, ctas in pf.shapes(b, "highest"):
            cfg = pf.launch_config(b, "highest", 44, (threads, ctas))
            print(f"[build] fine_spgemm b={b} highest, {threads} threads, sized for {ctas} "
                  f"per SM: {cfg}")
            if cfg["local_bytes"] != 0 or cfg["blocks_per_sm"] < ctas:
                raise AssertionError(f"fine_spgemm b={b} highest: {cfg}, want no spill and "
                                     f"{ctas} blocks per SM")


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
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf

    small_fine_edges(32, pf.NARROW[(32, "highest")])


@contextlib.contextmanager
def launch_shape_forced(shape):
    """Every fine-kernel launch inside runs in `shape` (one of
    pallas_gemm_fine.shapes), whatever `launch_shape` would pick."""
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf

    picked = pf.launch_shape
    pf.launch_shape = lambda *args: shape
    try:
        yield
    finally:
        pf.launch_shape = picked


def small_fine_edges(b, shape=None):
    """Phase 3: the fine kernel's edges against its plain version at leaf
    b, every tier, both layouts, with the B rows seen whole and capped at
    8: a 4 x 80 A whose row 0 holds all 80 entries (more than one
    k-chunk of staged A blocks, and a C row of more than CHUNK_SLOTS
    slots, so a chunk boundary inside it), row 1 empty (with two output
    slots that no product reaches), row 2 one entry (slots with one
    product), row 3 only entries whose B rows are empty (an empty C row),
    and a tail of five SENTINEL slots.  Each tier runs in the shape
    `launch_shape` picks; with `shape` given, "highest" alone, in that
    shape (the narrow one at b = 32, which this product's one column window
    would not pick)."""
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
    for prec in ("highest",) if shape else ("highest", "high", "default"):
        picked = shape or pf.launch_shape(b, prec, out_cap, nbr, nbc, B.ids.shape[0])
        kc = pf.launch_config(b, prec, mbr, picked)["kc"]
        if kc >= 80:
            raise AssertionError(f"b={b} {prec}: k-chunk {kc} holds A's row 0 whole")
        for layout, (ad, bd) in data.items():
            for cap in (mbr, 1):
                args = (A.ids, ad, B.ids, bd, out_ids, nbr, nbrB, nbc, out_cap, cap, mcr)
                kw = dict(precision=prec, block_size=b, out_layout=layout, alpha=-0.5)
                with launch_shape_forced(picked):
                    got = pf.fine_spgemm(*args, **kw, tables=tables)
                want = pf.fine_spgemm_reference(*args, **kw)
                torch.cuda.synchronize()
                # Relative to max|C|: up to 17 products per slot, and the
                # tensor cores' f32 sums round otherwise than the plain
                # version's, so a small element of a long sum may differ by
                # more than 1e-5 of itself.
                err = rel_err(got, want)
                if not err <= TOL[prec]:
                    raise AssertionError(f"edges b={b} {prec} {layout} cap {cap}: "
                                         f"rel err {err:.3e} > {TOL[prec]}")
                if torch.count_nonzero(got[zero_slots]) != 0:
                    raise AssertionError(f"b={b} {prec} {layout}: a slot with no product")
                print(f"  edges b={b:2d} {prec:8s} {layout:9s} B row cap "
                      f"{'whole' if cap == mbr else 8:5}: kernel-vs-plain rel err="
                      f"{err:.3e} ({picked[0]} threads, k-chunk {kc}, C row 0 {row0} slots, "
                      f"products per slot 0..{int(per_slot.max())})")


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


def small_rows(widths=(128,)):
    """Phase 3 (b = 128) and phase 21(a) (b = 256 and 384): the row-panel
    kernel vs its plain version at each leaf width."""
    for b in widths:
        small_rows_at(b)


def small_rows_at(b):
    """The row-panel kernel vs its plain version at one leaf width: the
    three tiers, bf16 data, the SpAMM skip, triu and the aligned
    accumulator, on rectangular operands with an empty row, union slots no
    product reaches and a SENTINEL tail."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import (
        rows_spgemm,
        rows_spgemm_reference,
    )
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

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
    for label, opts in cases:
        cargs, prec = args, label
        if label == "bf16":
            cargs = args[:1] + (A.data.bfloat16(),) + args[2:3] + (B.data.bfloat16(),) + args[4:]
            prec = "highest"
        got = rows_spgemm(*cargs, precision=prec, **opts)
        want = rows_spgemm_reference(*cargs, precision=prec, **opts)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        name = f"b={b} {label} {sorted(opts) or ''}"
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
    """Kernel name -> the wrapper that counts its launches, for the paths'
    exact counts (the union-add: one launch an add on the card; the fine
    epilogue: one a fine-branch spgemm; the truncate kernels: two passes a
    truncation)."""
    from hierarchical_block_sparse_lib_tpu_torch.kernels import (
        fine_epilogue,
        micro_fine,
        pallas_gemm,
        pallas_gemm_fine,
        pallas_gemm_groups,
        pallas_gemm_rows,
        pallas_gemm_stream,
        pallas_norms,
        truncate,
        union_add,
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
        "union_add": union_add.union_add,
        "fine_epilogue": fine_epilogue.fine_epilogue,
        "truncate": truncate.truncate_kernel,
    }


def counts(names=B3_KERNELS):
    return {name: wrappers()[name].launches for name in names}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def launched(want: dict, path: str) -> dict:
    """Every count as the path must leave it (zero for kernels not named),
    or raise."""
    got = {k: v for k, v in counts(wrappers()).items() if v}
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
    # block_frob_squared's call above is host-bound: its kernel's device
    # time per launch beside its bound.
    fb_bound = bound(2 * ydata.numel(), nbytes_norms + cap * 4)
    fdev = device_profile(f"block_frob_squared at out_cap {cap}", lambda: pn.block_frob_squared(ydata),
                          10, card, top=2)
    fb_us = per_call_us(fdev, 10, "block_norms_kernel")
    fb_device = dict(device_ms=fb_us / 1e3 if fb_us else None,
                     share_fp32=fb_bound[0] * 1e3 / fb_us if fb_us else None)
    print(f"[time]   block_frob_squared kernel "
          + (f"{fb_us:.1f} us" if fb_us else "not measured") + f" per launch; bound "
          f"{fb_bound[0] * 1e3:.1f} us ({fb_bound[1]}): {pct(fb_device['share_fp32'])} of it")

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
            plain_ms=t["block_frob_squared"][1], bound=fb_bound, library_ms=lib_ms,
            **fb_device),
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
    got = launched({"gather_gemm_accumulate_stream": steps, "norms_and_keep": steps,
                    "truncate": 2 * steps}, "purify on B3")
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
    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import run_slots
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
    seg = run_slots(plan.c_id, oc)[0].to(torch.int32)
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
    LEAF128["B4full device ms"] = b["device_ms"]
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
    memory); save/load bitwise.  Returns the multiplies' launches (one
    fine_spgemm and one fine_epilogue each)."""
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
        got = launched({"fine_spgemm": 2, "fine_epilogue": 2},
                       "two B2 multiplies through the class (product, output pass)")
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
    return got


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
    got = launched({"rows_spgemm": 1, "union_add": 1}, "syrk at B3 (product, mirror's add)")
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
    return got


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
    syrk = syrk_b3(card, A3)
    sym = symmetric_b3(card, A3, prof, plans, scan)
    out = {"fine_spgemm": fine["fine_spgemm"], "fine_epilogue": fine["fine_epilogue"],
           "rows_spgemm": syrk["rows_spgemm"] + sym["rows_spgemm"],
           "norms_and_keep": sym["norms_and_keep"], "union_add": syrk["union_add"]}
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
    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import run_slots

    if plan.n_unique is not None:
        return int(plan.n_unique)
    return int(run_slots(plan.c_id, plan.c_id.shape[0])[2])


def tight_caps(mul_plans, extra_out=()) -> tuple:
    """(pair_cap, out_cap) of a captured trajectory: the most surviving
    pairs of any of its products, and the most output blocks of any
    product, union or add (`extra_out`)."""
    return (max(int(p.total) for p in mul_plans),
            max([distinct_outputs(p) for p in mul_plans] + list(extra_out)))


def run_model(card, name, unplanned, planned, want_launches, adds=(0, 0)):
    """Launch counts around one unplanned and one planned call (each must
    be `want_launches`, with `adds` union-add launches: unplanned,
    planned), planned == unplanned bitwise, no flag; the call
    time (CUDA events, median of 7 after 2 warm-ups) and a profile of the
    planned call.  Returns (result, launches of both calls)."""
    import torch

    total = {}
    out = []
    for label, run, n_adds in (("unplanned", unplanned, adds[0]),
                               ("planned", planned, adds[1])):
        torch.cuda.synchronize()
        reset_counts()
        res = run()
        torch.cuda.synchronize()
        want = dict(want_launches, **({"union_add": n_adds} if n_adds else {}))
        got = launched(want, f"{name} ({label})")
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
          f"call {want_launches}, union-add {adds[0]} / {adds[1]}; {card}: call unplanned {times['unplanned']:.3f} ms, planned "
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
        {"gather_gemm_accumulate_stream": steps, "norms_and_keep": steps,
         "truncate": 2 * steps})
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
        {"rows_spgemm": terms, "norms_and_keep": terms, "truncate": 2 * terms},
        adds=(terms + 1, 1))  # planned, only the first add is not add_planned
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
        {"rows_spgemm": 75, "norms_and_keep": 25, "truncate": 50})
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
    got = launched({"block_frob_squared": 1, "truncate": 2}, "subtree truncate")
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
    got = {k: v for k, v in counts(wrappers()).items() if v}
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


def dist_flags(stats) -> list:
    return [f for f in ("overflow", "plan_mismatch") if f in stats and bool(stats[f])]


def same_shards(x, y) -> bool:
    """Two distributed matrices bitwise equal, shard by shard."""
    import torch

    return all(torch.equal(a.ids, b.ids) and torch.equal(a.data, b.data)
               for a, b in zip(x.shards, y.shards))


def against(label, Cd, ref, tol=DIST_TOL) -> float:
    """A distributed matrix gathered back, against a single-device one: the
    same stored ids, the data within `tol` of max|ref| (in f64).  Returns
    the rel err."""
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist

    U = dist.undistribute(Cd)
    n = int(ref.nnz)
    if int(U.nnz) != n or not bool((U.ids[:n] == ref.ids[:n]).all()):
        raise AssertionError(f"{label}: support differs ({int(U.nnz)} vs {n} blocks)")
    want = ref.data[:n].double()
    err = float((U.data[:n].double() - want).abs().max() / want.abs().max())
    if err > tol:
        raise AssertionError(f"{label}: rel err {err:.3e} > {tol}")
    return err


def counted(total: dict, want: dict, label: str, run):
    """run(), its launches checked to be exactly `want` and added to
    `total`."""
    sync_cards()
    reset_counts()
    out = run()
    sync_cards()
    for k, v in launched(want, label).items():
        total[k] = total.get(k, 0) + v
    return out


def ring_caps(ad, n_dev: int):
    """The ring's global worst-case (pair_cap, stage_out_cap): the largest
    exact plan over every (shard, stage), shard d holding B shard d - s at
    stage s."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    ids = ad.stacked_ids()
    plans = [native.plan_spgemm_ex(ids[d], ids[(d - s) % n_dev], ad.nb_cols, ad.nb_rows,
                                   ad.nb_cols)
             for d in range(n_dev) for s in range(n_dev)]
    return max(p[0] for p in plans), max(p[1] for p in plans)


def b5_route(mesh, A, total):
    """Phase 18's products at B5: the route plan against the JAX package's
    numbers; dist_spgemm_routed planned, frozen (unaligned: bitwise equal to
    planned) and frozen aligned (the default); the ring; the single-device
    planned spgemm; each against the f64 single-device product.  Returns
    what the times need."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route

    P = mesh.size
    Ad = dist.distribute(A, mesh)
    plan = route.plan_route(Ad, Ad, P)
    print(f"[dist] B5 {plan.summary()}")
    print(f"[dist]   per-device pairs {list(plan.per_device_pairs)}, per-stage blocks "
          f"{list(plan.per_stage_blocks)}, out_cap {plan.out_cap}, union row max "
          f"{plan.union_c_row_max}")
    got = dict(pairs=plan.total_pairs, per_device_pairs=plan.per_device_pairs,
               per_stage_blocks=plan.per_stage_blocks, blocks_routed=plan.blocks_routed,
               blocks_ring=plan.blocks_ring)
    want = {k: B5[k] for k in got}
    if got != want:
        raise AssertionError(f"B5 route plan {got} differs from the JAX package's {want}")
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    if (pc, oc) != (B5["pairs"], B5["out_blocks"]):
        raise AssertionError(f"B5 single-device plan {(pc, oc)}")
    routed = {"rows_spgemm": P * len(plan.stages)}
    t0 = time.perf_counter()
    frozen_u = route.freeze_route_plan(Ad, Ad, plan, aligned=False)
    frozen = route.freeze_route_plan(Ad, Ad, plan)
    torch.cuda.synchronize()
    print(f"[dist]   freeze (unaligned and aligned) {time.perf_counter() - t0:.2f} s; "
          f"default aligned={frozen.aligned}")
    if not frozen.aligned:
        raise AssertionError("B5's frozen plan is not aligned (8 stages, b = 128)")
    runs = {}
    for name, pl in (("planned", plan), ("frozen", frozen_u), ("frozen aligned", frozen)):
        runs[name] = counted(total, routed, f"B5 routed {name}",
                             lambda pl=pl: route.dist_spgemm_routed(Ad, Ad, mesh, pl))
        st = runs[name][1]
        if dist_flags(st) or int(st["n_block_pairs"]) != B5["pairs"] or tuple(
                st["per_device_pairs"].tolist()) != B5["per_device_pairs"]:
            raise AssertionError(f"B5 routed {name}: stats {st}")
    if not same_shards(runs["planned"][0], runs["frozen"][0]):
        raise AssertionError("B5 frozen routed product is not bitwise equal to the planned one")
    pl1 = hbsm.make_plan(A, A, pc)
    C1, info1 = counted(total, {"rows_spgemm": 1}, "B5 single-device planned spgemm",
                        lambda: hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr), plan=pl1))
    if flags_set(info1):
        raise AssertionError(f"B5 single-device flags {flags_set(info1)}")
    a64 = A.with_data(A.data.double())
    C64, _ = hbsm.spgemm(a64, a64, pc, oc, backend="xla")
    del a64
    ring_pc, ring_oc = ring_caps(Ad, P)
    ring = counted(total, {"gather_gemm_accumulate_stream": P * P, "union_add": P * P},
                   "B5 ring",
                   lambda: dist.dist_spgemm(Ad, Ad, mesh, ring_pc, plan.out_cap,
                                            stage_out_cap=ring_oc))
    if int(ring[1]) != B5["pairs"] or bool(ring[2]):
        raise AssertionError(f"B5 ring: pairs {int(ring[1])}, overflow {bool(ring[2])}")
    errs = {name: against(f"B5 routed {name}", runs[name][0], C64) for name in runs}
    errs["ring"] = against("B5 ring", ring[0], C64)
    n1 = int(C1.nnz)
    errs["single-device"] = float((C1.data[:n1].double() - C64.data[:n1]).abs().max()
                                  / C64.data[:n1].abs().max())
    print(f"[dist]   routed planned, frozen, frozen aligned: {B5['pairs']} pairs, "
          f"{B5['out_blocks']} output blocks as the single-device product; frozen == planned "
          f"bitwise; ring (caps pair {ring_pc}, stage out {ring_oc}, out {plan.out_cap}) "
          f"{int(ring[1])} pairs; rel err vs the f64 single-device product "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if errs["single-device"] > DIST_TOL:
        raise AssertionError(f"B5 single-device rel err {errs['single-device']:.3e}")
    del runs, ring, C1
    torch.cuda.empty_cache()
    return Ad, plan, (frozen_u, frozen), (pc, oc, mbr, mcr), pl1, (ring_pc, ring_oc), C64


def b5_route2(mesh, Ad, plan, C64, total):
    """Phase 18, two-level routing at B5, 2 x 4 and 4 x 2: the plan's
    traffic against the JAX package's, inter-host blocks at most the flat
    routed count, the product against the f64 single-device one."""
    from hierarchical_block_sparse_lib_tpu_torch.parallel import route2

    for (h, c), want in B5["route2"].items():
        mesh_hc = route2.make_mesh_2level(h, c)
        plan2 = route2.plan_route_2level(Ad, Ad, h, c)
        got = (plan2.dcn_blocks, plan2.dcn_blocks_flat, plan2.ici_blocks)
        if got != want or plan2.total_pairs != B5["pairs"] or plan2.dcn_blocks > plan.blocks_routed:
            raise AssertionError(f"B5 two-level {h}x{c}: {plan2.summary()}, expected {want}")
        muls = sum(cap is not None for caps in plan2.stage_caps for cap in caps)
        C2, st2 = counted(total, {"rows_spgemm": mesh.size * muls}, f"B5 two-level {h}x{c}",
                          lambda: route2.dist_spgemm_2level(Ad, Ad, mesh_hc, plan2))
        if dist_flags(st2) or int(st2["n_block_pairs"]) != B5["pairs"]:
            raise AssertionError(f"B5 two-level {h}x{c}: stats {st2}")
        err = against(f"B5 two-level {h}x{c}", C2, C64)
        print(f"[dist] B5 {plan2.summary()}; {muls} share multiplies a shard; rel err vs f64 "
              f"{err:.3e}; inter-host blocks <= flat routed {plan.blocks_routed}")


def b5_sp2(mesh, A, total):
    """Phase 18, one frozen routed SP2 step at B5 on a purifiable symmetric
    iterate (scripts/b5_route_full.py's), against the single-device
    sp2_step: pairs, kept blocks, ids, data within DIST_TOL."""
    import math

    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.models.purification import sp2_step
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route

    nb, b = B5["nb"], A.block_size
    S = hbsm.add(A, hbsm.transpose(A), alpha=0.5, beta=0.5)
    S = hbsm.scale(S, 1.0 / math.sqrt(float(hbsm.frob_squared(S))))
    X = hbsm.add(S, hbsm.eye(nb * b, b), beta=0.5, cap=S.cap + nb)
    del S
    tau, nocc = 1e-7, nb * b // 2
    pc, oc, mbr, mcr = plan_spgemm_ex(X, X)
    y_ref, st_ref = counted(
        total, {"rows_spgemm": 1, "norms_and_keep": 1, "truncate": 2},
        "B5 single-device SP2 step",
        lambda: sp2_step(X, tau, pair_cap=pc, out_cap=oc, target_trace=nocc, cap=oc,
                         row_caps=(mbr, mcr)))
    Xd = dist.distribute(X, mesh)
    xplan = route.plan_route(Xd, Xd, mesh.size)
    xfrozen = route.freeze_route_plan(Xd, Xd, xplan)
    want = {"rows_spgemm": mesh.size * len(xplan.stages), "norms_and_keep": mesh.size,
            "truncate": 2 * mesh.size,
            "union_add": mesh.size}  # each shard's blend is one add, each truncation two passes
    Yd, sst = counted(total, want, "B5 routed SP2 step",
                      lambda: route.dist_sp2_step_routed(Xd, mesh, xfrozen, tau, target_trace=nocc,
                                                         expect_ids=Xd.stacked_ids()))
    kept = sum(int(s.nnz) for s in Yd.shards)
    if dist_flags(sst) or (int(sst["n_block_pairs"]), kept) != (B5["sp2_pairs"], B5["sp2_kept"]):
        raise AssertionError(f"B5 routed SP2: pairs {int(sst['n_block_pairs'])}, kept {kept}, "
                             f"stats {sst}")
    err = against("B5 routed SP2 step", Yd, y_ref)
    print(f"[dist] B5 routed SP2 step (frozen, aligned={xfrozen.aligned}, expect_ids checked): "
          f"{int(sst['n_block_pairs'])} pairs over {len(xplan.stages)} stages, {kept} kept "
          f"blocks, trace {float(sst['trace']):.3f} (single device {float(st_ref.trace):.3f}); "
          f"rel err vs the single-device sp2_step {err:.3e}")
    del X, Xd, Yd, y_ref
    torch.cuda.empty_cache()


def cannon_b5(total):
    """Phase 18, Cannon on a 2 x 2 mesh at a B5 mix of 256 block rows
    (32768^2), its truncation and norm, against the f64 single-device
    product."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist2d
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import b5_mix

    A = b5_mix(256, 128)
    mesh2 = dist2d.make_mesh2d(2)
    A2 = dist2d.distribute2d(A, mesh2)
    pc, oc, _, _ = plan_spgemm_ex(A, A)
    C2, pairs, ovf = counted(total, {"gather_gemm_accumulate_stream": 8, "union_add": 8},
                             "Cannon 2x2",
                             lambda: dist2d.dist2d_spgemm(A2, A2, mesh2, pair_cap=pc, out_cap=oc,
                                                          stage_out_cap=oc))
    if int(pairs) != pc or bool(ovf):
        raise AssertionError(f"Cannon: pairs {int(pairs)} of {pc}, overflow {bool(ovf)}")
    a64 = A.with_data(A.data.double())
    C64, _ = hbsm.spgemm(a64, a64, pc, oc, backend="xla")
    err = against("Cannon 2x2", C2, C64)
    T2 = counted(total, {"norms_and_keep": 4, "truncate": 8}, "Cannon truncate",
                 lambda: dist2d.dist2d_truncate(C2, mesh2, 1e-8))
    f2 = float(dist2d.dist2d_frob_squared(T2, mesh2))
    f64 = float(torch.sum(C64.data ** 2))
    if abs(f2 - f64) > 1e-5 * f64:
        raise AssertionError(f"Cannon frob^2 {f2} vs f64 {f64}")
    print(f"[dist] Cannon 2x2 at a B5 mix of 256 block rows ({int(A.nnz)} blocks): {pc} pairs, "
          f"{oc} output blocks, rel err vs f64 {err:.3e}; truncate + frob^2 {f2:.6e} "
          f"(f64 {f64:.6e})")


def sync_cards() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def distribution_phase(card):
    """Phase 18: the distributed path (parallel/) on P = 8 logical shards
    (all on one card, or in contiguous groups over the visible cards).
    The dry run at tiny shapes, then B5 at its configured size (131072^2,
    b = 128): the route plan, the routed products, the ring, two-level
    routing at 2 x 4 and 4 x 2, one routed SP2 step, Cannon at 2 x 2, the
    traffic per exchange, the times in turns and profiles of the frozen
    routed call, aligned and not (on one card: CUDA events time one
    card), and the peak memory.  Returns the phase's
    launches of its three kernels."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.entry import dryrun_multichip
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import b5_mix

    t0 = time.perf_counter()
    sync_cards()
    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    P = 8
    dryrun_multichip(P)
    mesh = dist.make_mesh(P)
    one_card = len({d.index for d in mesh.devices.flat}) == 1
    print(f"[dist] mesh {mesh.shape}, shard -> device {[str(d) for d in mesh.devices.flat]}: "
          + ("with one card every collective passes references between shards on it, so this "
             "phase measures the routed algorithm's compute, gathers and host cost, not a link"
             if one_card else "collectives between shards on different cards are peer copies"))
    total = {}
    A = b5_mix(B5["nb"], 128)
    if int(A.nnz) != B5["nnz"]:
        raise AssertionError(f"B5 mix holds {int(A.nnz)} blocks, not {B5['nnz']}")
    Ad, plan, (frozen_u, frozen), (pc, oc, mbr, mcr), pl1, (ring_pc, ring_oc), C64 = b5_route(
        mesh, A, total)
    b5_route2(mesh, Ad, plan, C64, total)
    del C64
    torch.cuda.empty_cache()
    b5_sp2(mesh, A, total)
    cannon_b5(total)
    t_path = time.perf_counter() - t0

    routed = lambda: route.dist_spgemm_routed(Ad, Ad, mesh, frozen)  # noqa: E731
    routed_u = lambda: route.dist_spgemm_routed(Ad, Ad, mesh, frozen_u)  # noqa: E731
    with no_host_sync():
        routed()
    sync_cards()
    mesh.traffic.reset()
    routed()
    moves = [e[1:] for e in mesh.traffic.exchanges]
    mesh.traffic.reset()
    dist.dist_spgemm(Ad, Ad, mesh, ring_pc, plan.out_cap, stage_out_cap=ring_oc)
    ring_moves = [e[1:] for e in mesh.traffic.exchanges]
    print(f"[dist] the frozen routed call ran with no host sync; (blocks, of which between "
          f"cards) moved per exchange (padded panels, stages 1..7) {moves}, "
          f"{sum(m[0] for m in moves)} in all (the plan routes {plan.blocks_routed} stored "
          f"blocks); the ring's rotations {ring_moves}, {sum(m[0] for m in ring_moves)} in all "
          f"(ring count {plan.blocks_ring} stored blocks)")
    if one_card:
        times = in_turns({
            "routed frozen": routed,
            "routed frozen unaligned": routed_u,
            "routed planned": lambda: route.dist_spgemm_routed(Ad, Ad, mesh, plan),
            "ring": lambda: dist.dist_spgemm(Ad, Ad, mesh, ring_pc, plan.out_cap,
                                             stage_out_cap=ring_oc),
            "single-device planned": lambda: hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr),
                                                         plan=pl1),
        })
        print(f"[time] {card}: B5 products, 8 logical shards on one card (no link crossed), "
              f"CUDA events, median of 7 after 2 warm-up calls, in order then reversed")
        for name, (t1, t2) in times.items():
            print(f"[time]   {name:24s} {t1:.3f} / {t2:.3f} ms")
        device_profile("frozen routed B5 product (8 shards)", routed, 3, card, top=8)
        device_profile("frozen unaligned routed B5 product (8 shards)", routed_u, 3, card, top=8)
    else:
        print("[time] not measured: the shards span several cards and CUDA events time one")
    peak = max(torch.cuda.max_memory_allocated(i) for i in cards) / 2**30
    print(f"[phase18] path {t_path:.1f} s, phase {time.perf_counter() - t0:.1f} s; peak device "
          f"memory {peak:.2f} GiB (the fullest card); launches {total}")
    return total


# The bench's counters at full size, as the JAX package plans them (PERF.md
# §4): B2 at leaf 32 and B2-tile128 (pairs, output blocks), B1 (pairs,
# output blocks, leaf-16 multiplies), B3's pairs per step, B4's and
# B4full's pairs.
BENCH_COUNTS = dict(b2_leaf32=(335999, 189364), b2_tile128=B2T_COUNTS, b1=B1_COUNTS,
                    b3=B3_PROFILE["per_step_pairs"], b4=65716, b4full=4192475)
BENCH_STAGES = ("B2", "B2leaf32", "B2_default", "B1", "routed_1dev", "B3", "B4", "B4full",
                "B4_anchor")
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]


def entry_points_phase(card):
    """Phase 19: the port's two entry points.  Its acceptance checks in
    this process (all seven must pass), then its bench in a subprocess as
    a user runs it: exit 0; a last line with exactly bench.py's four keys,
    its metric and finite positive numbers; every stage's backend logged;
    the counters equal to the JAX package's plans.  CUDA events only, no
    profiler.  Returns the kernel launches of both: the acceptance's
    counted here, the bench's summed from its stage lines (each stage's
    counts read around it in the bench's process)."""
    import math

    import torch

    from hierarchical_block_sparse_lib_tpu_torch.scripts import acceptance

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    if acceptance.main() != 0:
        raise AssertionError("the acceptance checks did not run")
    torch.cuda.synchronize()
    total = {k: v for k, v in counts(wrappers()).items() if v}
    print(f"[phase19] acceptance: seven checks passed in {time.perf_counter() - t0:.1f} s; "
          f"launches {total}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "hierarchical_block_sparse_lib_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    stages, log_lines = {}, []
    for line in proc.stderr.splitlines():
        if line.startswith("[stage] "):
            rec = json.loads(line[len("[stage] "):])
            stages[rec.pop("stage")] = rec
        else:
            log_lines.append(line)
    for line in log_lines:
        print(f"[bench log] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"the bench exited {proc.returncode}")
    out = proc.stdout.strip().splitlines()
    head = json.loads(out[-1])
    if (list(head) != BENCH_KEYS or head["metric"] != "B2_hierarchical_spgemm_effective_gflops"
            or head["unit"] != "GFLOP/s"
            or not all(math.isfinite(head[k]) and head[k] > 0 for k in ("value", "vs_baseline"))):
        raise AssertionError(f"the bench's last line {out[-1]!r}")
    if tuple(stages) != BENCH_STAGES or not all(r.get("backend") for r in stages.values()):
        raise AssertionError(f"bench stages {list(stages)} or a backend not logged")
    got = dict(
        b2_leaf32=(stages["B2leaf32"]["direct"]["pairs"], stages["B2leaf32"]["direct"]["out"]),
        b2_tile128=(stages["B2"]["pairs"], stages["B2"]["out"]),
        b1=(stages["B1"]["pairs"], stages["B1"]["out"], stages["B1"]["leaf_pairs"]),
        b3=tuple(stages["B3"]["per_step_pairs"]), b4=stages["B4"]["pairs"],
        b4full=stages["B4full"]["pairs"])
    if got != BENCH_COUNTS:
        raise AssertionError(f"bench counters {got}, expected {BENCH_COUNTS}")
    print(f"[phase19] {card}: the bench (python -m hierarchical_block_sparse_lib_tpu_torch.bench), "
          f"{wall:.1f} s wall: exit 0, every stage's backend logged, counters as the JAX package "
          f"plans them; its stage table closes the [bench log] lines above")
    for res in stages.values():
        for name, n in res["stage_launches"].items():
            total[name] = total.get(name, 0) + n
    print(f"[phase19] bench headline: {out[-1]}")
    return total


# Phase 20: the eight ablation scripts, each with the port's kernels on
# its path (bench_scatter_accum times torch's ops, bench_planner_scaling
# the host planners, b5_route2_evidence's anchor runs "xla" at b = 8).
ABLATIONS = {
    "profile_b3": ("rows_spgemm", "norms_and_keep", "block_frob_squared"),
    "profile_scan": ("rows_spgemm", "norms_and_keep"),
    "bench_symmetric": ("rows_spgemm", "norms_and_keep"),
    "profile_routed_1dev": ("rows_spgemm",),
    "bench_scatter_accum": (),
    "bench_band_route": ("fine_spgemm",),
    "bench_planner_scaling": (),
    "b5_route2_evidence": (),
}


def ablation_counters(recs: dict, max_p) -> None:
    """Phase 20's counters against the JAX package's numbers: B3's profile,
    B2-tile128's, the symmetric A/B's pairs, the planners' traffic and
    docs/B5_ROUTE.md's table; the bitwise equalities."""
    from hierarchical_block_sparse_lib_tpu_torch.scripts import (
        b5_route2_evidence,
        bench_planner_scaling,
        bench_symmetric,
        profile_scan,
    )

    c = {name: rec["counters"] for name, rec in recs.items()}
    b3 = c["profile_b3"]
    got = dict(per_step_pairs=tuple(b3["per_step_pairs"]), per_step_out=tuple(b3["per_step_out"]),
               per_step_kept=tuple(b3["per_step_kept"]), pair_cap=b3["pair_cap"],
               out_cap=b3["out_cap"], cap=b3["cap"], row_caps=tuple(b3["row_caps"]))
    if got != B3_PROFILE:
        raise AssertionError(f"profile_b3: profile {got}, expected {B3_PROFILE}")
    scan = c["profile_scan"]
    if (scan["per_step_pairs"] != profile_scan.EXPECTED[(6144, 0.55, 7, 3, 1e-7)]
            or any(scan["plan_mismatch"]["full"])):
        raise AssertionError(f"profile_scan: pairs {scan['per_step_pairs']}, full's flags "
                             f"{scan['plan_mismatch']['full']}")
    for (name, n), want in bench_symmetric.EXPECTED.items():
        rec = c["bench_symmetric"][name]
        if ({k: rec[k] for k in want} != want or rec["n"] != n
                or rec["symmetric_vs_generic"] > bench_symmetric.TOL):
            raise AssertionError(f"bench_symmetric {name}: {rec}, expected {want}")
    r = c["profile_routed_1dev"]
    if (r["blocks"], r["pairs"], r["out"]) != (819, *B2T_COUNTS) or not r["passthrough"]:
        raise AssertionError(f"profile_routed_1dev: counters {r}")
    want = bench_planner_scaling.EXPECTED[(512, 8)]
    planner = c["bench_planner_scaling"]
    wf = {str(p): list(v) for p, v in want["flat"].items() if p <= max_p}
    wt = {k: list(v) for k, v in want["two"].items()
          if int(k.split("x")[0]) * int(k.split("x")[1]) <= max_p}
    if planner["flat"] != wf or planner["two"] != wt:
        raise AssertionError(f"bench_planner_scaling: {planner}, expected {wf}, {wt}")
    rows = {k: tuple(v) for k, v in c["b5_route2_evidence"]["rows"].items()}
    if (rows != b5_route2_evidence.EXPECTED[(1024, 8)]
            or any(rows[f"{h}x{cc}"][:3] != v for (h, cc), v in B5["route2"].items())):
        raise AssertionError(f"b5_route2_evidence: table {rows}")
    for name, key in (("profile_b3", "planned spgemm bitwise equal to unplanned"),
                      ("profile_scan", "full bitwise equal to purify_scan"),
                      ("bench_scatter_accum", "gather-add and scatter-add equal")):
        if recs[name]["checks"].get(key) is not True:
            raise AssertionError(f"{name}: check {key!r} not passed")


# Phase 20 stops the planner sweep at 16 shards: freezing the route plan
# grows as P^2 and the full sweep to 64 took 395 s alone (PERF.md §5).
PHASE20_MAX_P = 16


def ablation_phase(card, max_p: int = PHASE20_MAX_P) -> dict:
    """Phase 20: each ablation script run in its own process, as a user
    runs it (a fresh profiler each: late in this script the profiler can
    drop launch records): exit 0, its last line parsed, its checks passed,
    its path's kernels launched, its counters as ablation_counters holds
    them.  Prints one table of every part's call ms (median [min, max]),
    device ms and launches per call, each script's wall seconds and peak
    memory.  `max_p` cuts the planner sweep.  Returns the kernel launches
    of all eight (each script's count over its run)."""
    root = os.path.dirname(os.path.abspath(__file__))
    log_dir = os.path.join(root, "build", "phase20")
    os.makedirs(log_dir, exist_ok=True)
    total, recs, walls = {}, {}, {}
    t_phase = time.perf_counter()
    for name, kernels in ABLATIONS.items():
        args = ["--max-p", str(max_p)] if name == "bench_planner_scaling" else []
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "hierarchical_block_sparse_lib_tpu_torch.scripts." + name,
             *args],
            capture_output=True, text=True, timeout=600, cwd=root)
        walls[name] = time.perf_counter() - t0
        for ext, text in (("out", proc.stdout), ("err", proc.stderr)):
            with open(os.path.join(log_dir, f"{name}.{ext}"), "w") as f:
                f.write(text)
        if proc.returncode != 0:
            for line in proc.stderr.splitlines()[-30:]:
                print(f"[phase20 {name}] {line}")
            raise AssertionError(f"{name} exited {proc.returncode}")
        rec = recs[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        missing = [k for k in kernels if not rec["launches"].get(k)]
        if not rec["checks"] or not all(rec["checks"].values()) or missing:
            raise AssertionError(f"{name}: checks {rec['checks']}, kernels not launched {missing}")
        for k, n in rec["launches"].items():
            total[k] = total.get(k, 0) + n
    ablation_counters(recs, max_p)
    cut = "" if max_p >= 64 else (f"; the planner sweep cut to P <= {max_p} (bench_planner_scaling "
                                  f"alone runs it to 64)")
    print(f"[phase20] {card}: the eight ablation scripts (python -m "
          f"hierarchical_block_sparse_lib_tpu_torch.scripts.<name>), "
          f"{time.perf_counter() - t_phase:.1f} s{cut}: exit 0, checks passed, counters as the JAX "
          f"package's; logs in build/phase20/. Per part: call ms median [min, max] over two "
          f"turns, device ms and launches per call (torch.profiler)")
    for name, rec in recs.items():
        peak = "not measured" if rec["peak_gib"] is None else f"{rec['peak_gib']:.2f} GiB"
        print(f"[phase20] {name}: {walls[name]:.1f} s wall, peak {peak}, kernel launches "
              f"{rec['launches']}")
        for part, p in rec["parts"].items():
            dev = "not measured" if p["device_ms"] is None else f"{p['device_ms']:.3f}"
            launches = "not measured" if p["launches"] is None else f"{p['launches']:.1f}"
            print(f"[phase20]   {part:46s} {p['ms']:9.3f} [{p['min']:.3f}, {p['max']:.3f}]  "
                  f"device {dev}  launches {launches}")
        for diff, d in rec["derived"].items():
            dev = "not measured" if d["device_ms"] is None else f"{d['device_ms']:+.3f}"
            print(f"[phase20]   = {diff:44s} {d['ms']:+9.3f} (spread {d['spread']:.3f}"
                  f"{', inside: not a cost' if d['within_spread'] else ''})  device {dev}")
    return total


# Phase 21: the row-panel kernel at leaf 256, run in its own process
# (`python3 chip_smoke.py --phase21`), with a fresh profiler: late in this
# script, after phase 18's large profiles, the profiler can drop launch
# records.


def sampled_exact(A, out_ids, n=64):
    """f64 blocks of A @ A at n output ids spread evenly over the sorted
    stored `out_ids` (numpy): (the ids, [n, b, b] f64 on A's device)."""
    import torch

    nnz = int(A.nnz)
    a_ids = A.ids[:nnz].cpu().numpy().astype(np.int64)
    nbc = A.nb_cols
    pick = out_ids[np.unique(np.linspace(0, len(out_ids) - 1, n).astype(np.int64))]
    blocks = []
    for cid in pick.tolist():
        i, j = divmod(cid, nbc)
        lo, hi = np.searchsorted(a_ids, [i * nbc, (i + 1) * nbc])
        acc = torch.zeros((A.block_size, A.block_size), dtype=torch.float64, device=A.device)
        for e in range(lo, hi):
            want = a_ids[e] % nbc * nbc + j
            q = int(np.searchsorted(a_ids, want))
            if q < nnz and a_ids[q] == want:
                acc += A.data[e].double() @ A.data[q].double()
        blocks.append(acc)
    return pick, torch.stack(blocks)


def sampled_err(C, pick, exact) -> float:
    """max|C - exact| / max|exact| over the sampled blocks, C's stored ids
    sorted; raises if C lacks one of them."""
    import torch

    n = int(C.nnz)
    ids = C.ids[:n].cpu().numpy()
    pos = np.searchsorted(ids, pick)
    if np.any(pos >= n) or not np.array_equal(ids[np.minimum(pos, n - 1)], pick):
        raise AssertionError("a sampled output block is not stored")
    got = C.data[torch.from_numpy(pos).to(C.device)].double()
    return float((got - exact).abs().max() / exact.abs().max())


def device_per_call(dev, reps):
    """(device ms, launches) per call from device_profile's totals, or
    (None, None) when the profiler recorded nothing."""
    if not dev:
        return None, None
    return (sum(t for t, _ in dev.values()) / reps / 1e3,
            sum(c for _, c in dev.values()) // reps)


def b4_leaf256(card):
    """Phase 21(b), B4 at leaf 256: random_block_matrix(8192, 256, 0.5,
    seed=4) squared through the planned spgemm with row caps (auto ->
    "rows"), against the stream kernel's product and an f64 product;
    spamm (tau at the median pair-norm product), syrk (triu) and the
    aligned accumulate through their public calls, one rows_spgemm launch
    each; the kernel with the SpAMM skip and with triu against its plain
    version; the planned product timed in turns with B4 at leaf 128, and
    each leaf's kernel device time per launch against both bounds.
    Returns (its launches, its numbers)."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as pr
    from hierarchical_block_sparse_lib_tpu_torch.ops.norms import squared_threshold
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex, resolve_backend
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix

    b = 256
    A = random_block_matrix(8192, b, 0.5, seed=4)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    caps = (mbr, mcr)
    backend = resolve_backend(b, A.dtype, A.nb_cols, pc, row_caps=caps)
    plan = hbsm.make_plan(A, A, pc)
    print(f"[B4 b=256] 8192^2 b=256 50% seed 4: {int(A.nnz)} blocks, pairs {pc} "
          f"({2 * b**3 * pc / 1e9:.1f} GFLOP), out {oc}, row caps {caps}; auto -> {backend!r}")
    if backend != "rows":
        raise AssertionError(f"B4 at leaf 256 with row caps resolves to {backend!r}")
    total = {}
    C, info = counted(total, {"rows_spgemm": 1}, "B4 leaf 256 (planned spgemm)",
                      lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, row_caps=caps))
    if (int(info.n_block_pairs), int(info.n_out_blocks)) != (pc, oc) or flags_set(info):
        raise AssertionError(f"B4 leaf 256 counters or flags {flags_set(info)}")
    Cs, _ = hbsm.spgemm(A, A, pc, oc, plan=plan, backend="pallas")
    if not torch.equal(C.ids, Cs.ids):
        raise AssertionError("B4 leaf 256: rows and stream keep different blocks")
    err_s, same = rel_err(C.data, Cs.data), torch.equal(C.data, Cs.data)
    del Cs
    dA = hbsm.to_dense(A).double()
    err = rel_err(hbsm.to_dense(C).double(), dA @ dA)
    print(f"[B4 b=256] launches {total}; vs the stream kernel's product: "
          f"{'bitwise equal' if same else f'rel err {err_s:.3e}'}; vs the f64 product (every "
          f"block): rel err {err:.3e}")
    if err_s > 1e-5 or err > 1e-5:
        raise AssertionError(f"B4 leaf 256 rel errs: stream {err_s:.3e}, f64 {err:.3e}")

    # SpAMM through spamm, tau at the median pair-norm product.
    ids = A.ids.cpu().numpy()
    an = np.sqrt(hbsm.block_frob_squared(A).cpu().numpy())
    prods = np.sort(np.concatenate([p for _, _, p, _, _ in native._spamm_pairs(
        ids, an, ids, an, A.nb_cols, A.nb_cols)]))
    tau = gap_midpoint(prods, len(prods) // 2)
    pairs_f, out_f = hbsm.plan_spamm(A, A, tau)
    kw = dict(pair_cap=pc, out_cap=out_f, gemm_cap=pairs_f, row_caps=caps)
    Cf, inf = counted(total, {"rows_spgemm": 1, "block_frob_squared": 1},
                      "spamm at B4 leaf 256", lambda: hbsm.spamm(A, A, tau, backend="rows", **kw))
    if (int(inf.n_block_pairs), int(inf.n_out_blocks)) != (pairs_f, out_f) or flags_set(inf):
        raise AssertionError(f"spamm at B4 leaf 256: {int(inf.n_block_pairs)} pairs, flags "
                             f"{flags_set(inf)}")
    n2 = hbsm.block_frob_squared(A)
    fargs = (A.ids, A.data, A.ids, A.data, Cf.ids, A.nb_rows, A.nb_rows, A.nb_cols, out_f, mbr,
             mcr)
    skip = dict(a_norms2=n2, b_norms2=n2, tau2=squared_threshold(tau))
    k, p = pr.rows_spgemm(*fargs, **skip), pr.rows_spgemm_reference(*fargs, **skip)
    rel_f = rel_err(k, p)
    del k, p, Cf
    # triu through syrk (A @ A^T, upper blocks only), and the kernel's
    # triu launch on A @ A's slots against its plain version.
    Cy, iy = counted(total, {"rows_spgemm": 1, "union_add": 1}, "syrk at B4 leaf 256",
                     lambda: hbsm.syrk(A))
    err_y = rel_err(hbsm.to_dense(Cy).double(), dA @ dA.T)
    del Cy
    rargs = (A.ids, A.data, A.ids, A.data, C.ids, A.nb_rows, A.nb_rows, A.nb_cols, oc, mbr, mcr)
    k, p = pr.rows_spgemm(*rargs, triu=True), pr.rows_spgemm_reference(*rargs, triu=True)
    rel_t = rel_err(k, p)
    del k, p, dA
    # The aligned accumulate: A @ A + D, D on the product's support.
    gen = torch.Generator(device=A.device).manual_seed(21)
    D = C.with_data(torch.where(C.valid_mask()[:, None, None],
                                torch.randn(C.data.shape, generator=gen, device=A.device), 0))
    Ca, ia = counted(total, {"rows_spgemm": 1}, "aligned accumulate at B4 leaf 256",
                     lambda: hbsm.spgemm(A, A, pc, oc, accum=D, accum_aligned=True,
                                         backend="rows", row_caps=caps))
    if not torch.equal(Ca.ids, C.ids) or flags_set(ia):
        raise AssertionError(f"aligned accumulate at B4 leaf 256: ids or flags {flags_set(ia)}")
    err_a = rel_err(Ca.data, C.data + D.data)
    del Ca, D
    print(f"[B4 b=256] spamm: tau {tau:.6e}, {pairs_f} of {pc} pairs, {out_f} blocks; the "
          f"kernel with the skip vs plain rel err {rel_f:.3e}; syrk vs f64 A A^T rel err "
          f"{err_y:.3e} ({int(iy.n_block_pairs)} upper pairs); the kernel with triu vs plain "
          f"rel err {rel_t:.3e}; aligned accumulate vs C + D rel err {err_a:.3e}; launches {total}")
    if max(rel_f, rel_t) > ROWS_TOL or max(err_y, err_a) > 1e-5:
        raise AssertionError(f"B4 leaf 256 options: skip {rel_f:.3e}, triu {rel_t:.3e}, syrk "
                             f"{err_y:.3e}, aligned {err_a:.3e}")

    # In turns with B4 at leaf 128 (phase 15's input), and each kernel's
    # device time per launch against both bounds.
    A1 = random_block_matrix(8192, 128, 0.5, seed=4)
    pc1, oc1, mbr1, mcr1 = plan_spgemm_ex(A1, A1)
    plan1 = hbsm.make_plan(A1, A1, pc1)
    runs = {
        "leaf 256": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan, row_caps=caps),
        "leaf 128": lambda: hbsm.spgemm(A1, A1, pc1, oc1, plan=plan1, row_caps=(mbr1, mcr1)),
    }
    times = in_turns(runs)
    shapes = {"leaf 256": (A, pc, oc), "leaf 128": (A1, pc1, oc1)}
    numbers = {}
    for name, run in runs.items():
        M, npc, noc = shapes[name]
        bb = M.block_size
        dev = device_profile(f"planned spgemm at B4 {name}", run, 5, card, top=4)
        numbers[name] = tile_bounds(2 * bb**3 * npc, M.data.numel() * 4 + noc * bb * bb * 4,
                                    per_call_us(dev, 5, "rows_spgemm_kernel"))
    print(f"[time] {card}: B4 8192^2 planned spgemm on 'rows', CUDA events, median of 7 after "
          f"2 warm-up calls, in order then reversed")
    for name, (t1, t2) in times.items():
        nb = numbers[name]
        dev_us = "not measured" if nb["device_ms"] is None else f"{1e3 * nb['device_ms']:.1f} us"
        print(f"[time]   {name}: call {t1:.3f} / {t2:.3f} ms; rows_spgemm {dev_us} a launch "
              f"({shapes[name][1]} products); bounds FP32 {nb['bound_fp32_ms']:.3f} ms "
              f"({pct(nb['share_fp32'])}), 3xTF32 {nb['bound_route_ms']:.3f} ms "
              f"({pct(nb['share_route'])})")
    return total, {name: dict(numbers[name], call_ms=times[name]) for name in runs}


def b4full_leaf256(card):
    """Phase 21(c), B4full at leaf 256: random_block_matrix(32768, 256,
    0.5, seed=4) through plan_colslab(8) and spgemm_colslab on the
    row-panel kernel, against the plan's counters and an f64 product one
    slab of columns at a time (as phase 15 checks leaf 128); the call's
    time, the kernel's device time per slab launch against both bounds,
    the peak memory.  Returns (its launches, its numbers)."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.slab import plan_colslab
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix

    n, n_slabs, b = 32768, 8, 256
    t0 = time.perf_counter()
    A = random_block_matrix(n, b, 0.5, seed=4)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_colslab(A, A, n_slabs)
    plan_s = time.perf_counter() - t0
    flops = 2 * b**3 * plan.total_pairs
    print(f"[B4full b=256] {n}^2 b=256 50% seed 4: {int(A.nnz)} blocks "
          f"({A.data.numel() * 4 / 1e9:.2f} GB), made in {gen_s:.1f} s; plan_colslab({n_slabs}) "
          f"{plan_s:.2f} s on the host: pairs {plan.total_pairs} ({flops / 1e12:.2f} TFLOP), out "
          f"{plan.n_out} blocks ({plan.n_out * b * b * 4 / 1e9:.2f} GB), "
          f"{plan.total_pairs / plan.n_out:.1f} products a slot")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    total = {}
    t0 = time.perf_counter()
    C, info = counted(total, {"rows_spgemm": n_slabs}, "B4full leaf 256 (spgemm_colslab)",
                      lambda: hbsm.spgemm_colslab(A, A, plan=plan))
    first_s = time.perf_counter() - t0
    peak_call = torch.cuda.max_memory_allocated() - base
    cnt = (int(info.n_block_pairs), int(info.n_out_blocks))
    if cnt != (plan.total_pairs, plan.n_out) or flags_set(info):
        raise AssertionError(f"B4full leaf 256 counters {cnt} vs plan, flags {flags_set(info)}")
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
    print(f"[B4full b=256] launches {total}; first call {first_s:.2f} s; counters {cnt} as "
          f"planned, no flag; the call's peak above its inputs {peak_call / 2**30:.2f} GiB; vs "
          f"the f64 product (one slab of columns at a time): rel err {err:.3e}")
    if err > 1e-5:
        raise AssertionError(f"B4full leaf 256 rel err {err:.3e} > 1e-5")
    run = lambda: hbsm.spgemm_colslab(A, A, plan=plan)  # noqa: E731
    call, call_times = cuda_time_ms(run, warmup=1, reps=3)
    dev = device_profile("spgemm_colslab at B4full leaf 256", run, 2, card, unit="call", top=6)
    nbytes = A.data.numel() * 4 + plan.n_out * b * b * 4
    bnd = tile_bounds(flops, nbytes, per_call_us(dev, 2, "rows_spgemm_kernel"))
    per_launch = None if bnd["device_ms"] is None else bnd["device_ms"] / n_slabs
    print(f"[time] {card}: B4full leaf 256, CUDA events, median of 3 after 1 warm-up call: "
          f"call {call:.1f} ms [{min(call_times):.1f}, {max(call_times):.1f}] = "
          f"{100 * bnd['bound_route_ms'] / call:.1f}% of its {bnd['bound_route_ms']:.1f} ms 3xTF32 "
          f"bound; rows_spgemm "
          + ("not measured" if per_launch is None else
             f"{bnd['device_ms']:.1f} ms a call, {per_launch:.2f} ms")
          + f" per slab launch ({plan.total_pairs / n_slabs:.0f} products; bounds a launch FP32 "
          f"{bnd['bound_fp32_ms'] / n_slabs:.2f} ms ({pct(bnd['share_fp32'])}), 3xTF32 "
          f"{bnd['bound_route_ms'] / n_slabs:.2f} ms ({pct(bnd['share_route'])})); bytes "
          f"{1e3 * nbytes / 3.35e12:.2f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return total, dict(bnd, call_ms=call)


def b5_leaf256(card):
    """Phase 21(d), B5 at leaf 256: b5_mix(512, 256, seed=7), 131072^2, on
    8 logical shards (phase 18's mesh): the frozen plan's aligned decision
    (the reference's rule; tests/test_torch_route_wide.py holds it equal to
    the JAX package's), the frozen aligned and frozen generic routed
    products and the single-device planned spgemm, against each other and
    an f64 oracle on sampled blocks; their call times in turns, device ms
    and launches per call.  Returns (its launches, its numbers)."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import b5_mix

    P = 8
    mesh = dist.make_mesh(P)
    A = b5_mix(512, 256, seed=7)
    Ad = dist.distribute(A, mesh)
    plan = route.plan_route(Ad, Ad, P)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    t0 = time.perf_counter()
    frozen = route.freeze_route_plan(Ad, Ad, plan)
    frozen_u = route.freeze_route_plan(Ad, Ad, plan, aligned=False)
    sync_cards()
    print(f"[B5 b=256] b5_mix(512, 256, seed 7): {int(A.nnz)} blocks "
          f"({A.data.numel() * 4 / 1e9:.2f} GB), {pc} pairs, {oc} output blocks; {plan.summary()}; "
          f"stage row caps {list(plan.stage_row_caps)}, union row max {plan.union_c_row_max}; "
          f"freeze (aligned and generic) {time.perf_counter() - t0:.2f} s; default "
          f"aligned={frozen.aligned}")
    if not frozen.aligned or plan.total_pairs != pc:
        raise AssertionError(f"B5 leaf 256: aligned {frozen.aligned}, pairs {plan.total_pairs} "
                             f"vs {pc}")
    total = {}
    routed = {"rows_spgemm": P * len(plan.stages)}
    runs = {}
    for name, fz in (("frozen aligned", frozen), ("frozen generic", frozen_u)):
        runs[name] = counted(total, routed, f"B5 leaf 256 routed {name}",
                             lambda fz=fz: route.dist_spgemm_routed(Ad, Ad, mesh, fz))
        st = runs[name][1]
        if dist_flags(st) or int(st["n_block_pairs"]) != pc:
            raise AssertionError(f"B5 leaf 256 routed {name}: stats {st}")
    pl1 = hbsm.make_plan(A, A, pc)
    C1, info1 = counted(total, {"rows_spgemm": 1}, "B5 leaf 256 single-device spgemm",
                        lambda: hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr), plan=pl1))
    if flags_set(info1):
        raise AssertionError(f"B5 leaf 256 single-device flags {flags_set(info1)}")
    agree = {name: against(f"B5 leaf 256 routed {name}", runs[name][0], C1) for name in runs}
    pick, exact = sampled_exact(A, C1.ids[:oc].cpu().numpy(), 64)
    oracle = {name: sampled_err(dist.undistribute(runs[name][0]), pick, exact) for name in runs}
    oracle["single-device"] = sampled_err(C1, pick, exact)
    print(f"[B5 b=256] launches {total}; routed vs single-device rel err "
          + ", ".join(f"{k} {v:.3e}" for k, v in agree.items())
          + f"; vs the f64 product on {len(pick)} sampled blocks "
          + ", ".join(f"{k} {v:.3e}" for k, v in oracle.items()))
    if max(oracle.values()) > 1e-5:
        raise AssertionError(f"B5 leaf 256 vs f64: {oracle}")
    del runs, C1, exact
    torch.cuda.empty_cache()
    calls = {
        "routed frozen aligned": lambda: route.dist_spgemm_routed(Ad, Ad, mesh, frozen),
        "routed frozen generic": lambda: route.dist_spgemm_routed(Ad, Ad, mesh, frozen_u),
        "single-device planned": lambda: hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr),
                                                     plan=pl1),
    }
    times = in_turns(calls)
    numbers = {}
    for name, run in calls.items():
        dev_ms, n_launch = device_per_call(device_profile(f"B5 leaf 256 {name}", run, 3, card,
                                                          top=5), 3)
        numbers[name] = dict(call_ms=times[name], device_ms=dev_ms, launches=n_launch)
    print(f"[time] {card}: B5 leaf 256, 8 logical shards on one card, CUDA events, median of 7 "
          f"after 2 warm-up calls, in order then reversed; device ms and launches per call "
          f"from torch.profiler")
    for name, nb in numbers.items():
        t1, t2 = nb["call_ms"]
        dev = "not measured" if nb["device_ms"] is None else f"{nb['device_ms']:.3f} ms"
        print(f"[time]   {name:24s} call {t1:.3f} / {t2:.3f} ms; device {dev}, "
              f"{nb['launches']} launches a call")
    return total, numbers


def wide_leaf_path(card) -> dict:
    """Phase 21's work, in this process: the row-panel kernel at b = 256
    and 384 against its plain version at small shapes (and b = 192
    refused), then B4, B4full and B5 at leaf 256.  Returns its launches and
    numbers."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import rows_spgemm

    t0 = time.perf_counter()
    print("[phase21] the row-panel kernel at leaf 256: small shapes vs plain (b = 256, 384)")
    small_rows((256, 384))
    ids = torch.zeros(2, dtype=torch.int32, device=DEVICE)
    data = torch.zeros((2, 192, 192), device=DEVICE)
    try:
        rows_spgemm(ids, data, ids, data, ids, 1, 1, 2, 2, 2, 2)
    except ValueError as e:
        print(f"  rows b=192 refused on the card: {e}")
    else:
        raise AssertionError("rows_spgemm took b = 192 on the card")
    launches, numbers = {}, {}
    for name, part in (("B4", b4_leaf256), ("B4full", b4full_leaf256), ("B5", b5_leaf256)):
        got, numbers[name] = part(card)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
    print(f"[phase21] {time.perf_counter() - t0:.1f} s; launches {launches}")
    return {"launches": launches, "numbers": numbers}


def phase_process(phase: str, timeout: int):
    """`python3 chip_smoke.py --<phase>` in its own process: its report
    relayed, its stderr under build/<phase>.err, exit 0 or raise.  Returns
    the JSON object of its last line."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), f"--{phase}"],
                          capture_output=True, text=True, timeout=timeout, cwd=root)
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with open(os.path.join(root, "build", f"{phase}.err"), "w") as f:
        f.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    if proc.returncode != 0:
        for line in proc.stderr.splitlines()[-30:]:
            print(f"[{phase}] {line}")
        raise AssertionError(f"{phase} exited {proc.returncode}")
    return json.loads(lines[-1])


def wide_leaf_phase(card) -> dict:
    """Phase 21 in its own process (`python3 chip_smoke.py --phase21`).
    Prints leaf 256's B4full device time beside phase 15's leaf 128.
    Returns its kernel launches."""
    t0 = time.perf_counter()
    rec = phase_process("phase21", 600)
    full = rec["numbers"]["B4full"]
    leaf128 = LEAF128.get("B4full device ms")
    print(f"[phase21] {card}: B4full device time a call in rows_spgemm, leaf 128 (phase 15) "
          + ("not measured" if leaf128 is None else f"{leaf128:.1f} ms")
          + ", leaf 256 "
          + ("not measured" if full["device_ms"] is None else f"{full['device_ms']:.1f} ms")
          + f"; phase wall {time.perf_counter() - t0:.1f} s (its own process)")
    return rec["launches"]


# Phase 22: the members the surface walk (tests/test_torch_surface.py)
# required of the port, on the card, in its own process
# (`python3 chip_smoke.py --phase22`).


def host_members(ids, nbc):
    """numpy's block rows, block cols and make_id of the two from the host
    copy of the ids: int32, padding SENTINEL, make_id wrapping in int32 on
    padding as the card's int32 arithmetic does."""
    s = np.int32(np.iinfo(np.int32).max)
    valid = ids != s
    rows = np.where(valid, ids // nbc, s).astype(np.int32)
    cols = np.where(valid, ids % nbc, s).astype(np.int32)
    made = (rows.astype(np.int64) * nbc + cols).astype(np.int32)
    return rows, cols, made


def members_on_card(label, A) -> None:
    """block_rows, block_cols, make_id and density of A on the card with no
    host sync, against numpy's from the host copy of the ids; density
    bitwise against numpy's float32 division."""
    import torch

    with no_host_sync():
        rows, cols = A.block_rows(), A.block_cols()
        made = A.make_id(rows, cols)
        dens = A.density()
    torch.cuda.synchronize()
    want = host_members(A.ids.cpu().numpy(), A.nb_cols)
    for name, got, w in zip(("block_rows", "block_cols", "make_id"), (rows, cols, made), want):
        if got.device != A.device or got.dtype != torch.int32:
            raise AssertionError(f"{label} {name}: {got.dtype} on {got.device}")
        if not np.array_equal(got.cpu().numpy(), w):
            raise AssertionError(f"{label} {name} differs from numpy's")
    nnz, grid = int(A.nnz), A.nb_rows * A.nb_cols
    want_d = np.float32(nnz) / np.float32(grid)
    got_d = dens.cpu().numpy()
    if dens.device != A.device or got_d.shape != () or got_d.tobytes() != want_d.tobytes():
        raise AssertionError(f"{label} density {got_d!r} on {dens.device}, numpy {want_d!r}")
    if A.make_id(A.nb_rows - 1, A.nb_cols - 1) != grid - 1:
        raise AssertionError(f"{label} make_id on Python ints")
    print(f"[phase22] {label}: {nnz} blocks in {A.cap} slots: block_rows, block_cols, make_id "
          f"equal numpy's (int32, padding included); density {float(got_d)!r} = {nnz}/{grid} "
          f"bitwise; no host sync")


def members_path() -> dict:
    """Phase 22's work, in this process.  Launches no kernel; returns its
    wall time."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix

    t0 = time.perf_counter()
    for label, args in (("B2 16384^2 leaf 32", (16384, 32, 0.05, 2)),
                        ("B4 8192^2 leaf 256", (8192, 256, 0.5, 4))):
        A = random_block_matrix(*args[:3], seed=args[3])
        members_on_card(label, A)
        members_on_card(label + " with 5 padding slots", hbsm.repack(A, A.cap + 5))
        if args[1] == 32:
            if int(A.nnz) != 13107:
                raise AssertionError(f"B2 holds {int(A.nnz)} blocks, not 13 107")
            fr = hbsm.fine_pack(A).fr
            if fr != 8:
                raise AssertionError(f"B2 FineFlat.fr {fr}, expected 8")
            print(f"[phase22] {label}: FineFlat.fr {fr}")
        del A
    # 5 of 6 blocks: numpy's 5/6 is 0.8333333, 5 * (1/6) is 0.8333334.
    d = np.ones((64, 96), np.float32)
    d[32:, 64:] = 0.0
    G = hbsm.from_dense(torch.from_numpy(d).to(DEVICE), block_size=32)
    members_on_card("2 x 3 grid of 5 blocks", G)
    recip = float(G.nnz.to(torch.float32) / 6)
    print(f"[phase22] 2 x 3 grid: a Python divisor gives {recip!r} on the card, density "
          f"{float(G.density())!r}")
    seconds = time.perf_counter() - t0
    print(f"[phase22] {seconds:.1f} s")
    return {"seconds": seconds}


def members_phase() -> None:
    """Phase 22 in its own process (`python3 chip_smoke.py --phase22`)."""
    t0 = time.perf_counter()
    phase_process("phase22", 300)
    print(f"[phase22] phase wall {time.perf_counter() - t0:.1f} s (its own process)")


# Phase 23: the union-add kernel at the B2 chain's add, in its own process
# (`python3 chip_smoke.py --phase23`).


def union_add_path(card) -> dict:
    """Phase 23's work, in this process: the add of the B2 chain (C =
    0.5 A.A through the planned fine product, then C + 0.25 A) through the
    kernel, its plain version and the former add, bit for bit; call times
    in turns; device time of the slot pass and the block pass against the
    block pass's byte bound; device operations a call."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels.union_add import (
        union_add,
        union_add_reference,
    )
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix

    # The yardstick the tests share (tests/former_add.py, no jax).
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from former_add import former_add

    A = random_block_matrix(16384, 32, 0.05, seed=2)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    Af = hbsm.fine_pack(A)
    plan = hbsm.make_fine_plan(Af, Af, pc, oc, (mbr, mcr))
    C, _ = hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan)
    del plan, A
    cap = C.cap + Af.cap
    args = (C.ids, C.data, Af.ids, Af.data, 1.0, 0.25, cap)
    torch.cuda.synchronize()
    reset_counts()
    got = union_add(*args)
    torch.cuda.synchronize()
    launched({"union_add": 1}, "the B2 chain's add")
    plain = union_add_reference(*args)
    err = float((got[1] - plain[1]).abs().max())
    for label, want in (("plain version", plain), ("former add", former_add(*args))):
        for g, w in zip(got, want):
            g, w = (g.view(torch.int32), w.view(torch.int32)) if g.is_floating_point() else (g, w)
            if not torch.equal(g, w):
                raise AssertionError(f"union-add kernel differs from the {label} at B2")
        print(f"[phase23] B2 add ({int(C.nnz)} + {int(Af.nnz)} blocks, cap {cap}, union "
              f"{int(got[2])}): kernel bitwise equal to the {label}")
    print(f"[phase23] B2 add: kernel vs plain version max abs err {err:.3e}")
    del got, plain
    ms, plain_ms, four = alternate(lambda: union_add(*args), lambda: union_add_reference(*args))
    turns = in_turns({"kernel": lambda: union_add(*args), "former": lambda: former_add(*args)})
    print(f"[time] {card}: union-add at B2, median of 7, in turns plain, kernel, kernel, "
          f"plain: kernel {four[0]:.3f} / {four[1]:.3f} ms, plain {four[2]:.3f} / "
          f"{four[3]:.3f} ms; in turns kernel, former, former, kernel: kernel "
          f"{turns['kernel'][0]:.3f} / {turns['kernel'][1]:.3f} ms, former add "
          f"{turns['former'][0]:.3f} / {turns['former'][1]:.3f} ms; one-call library: none "
          f"(no torch call forms a sorted union)")
    reps = 20
    dev = device_profile("union-add at B2", lambda: union_add(*args), reps, card)
    old = device_profile("former add at B2", lambda: former_add(*args), reps, card)
    block_us = per_call_us(dev, reps, "union_blocks_kernel")
    slot_us = per_call_us(dev, reps) - block_us
    ops_new = sum(n for _, n in dev.values()) / reps
    ops_old = sum(n for _, n in old.values()) / reps
    # The block pass reads each landing block once and writes every slot;
    # ids, source maps and the slot pass's scratch are ~0.3% of it.
    landing = int(C.nnz) + int(Af.nnz)
    block_bytes = (landing + cap) * C.data[0].numel() * C.data.element_size()
    bound_ms, by = bound(0, block_bytes)
    share = bound_ms * 1e3 / block_us if block_us else None
    print(f"[phase23] {card}: block pass {block_us:.1f} us a call against its byte bound "
          f"{bound_ms * 1e3:.1f} us ({landing} blocks read, {cap} written, "
          f"{block_bytes / 1e9:.3f} GB at 3.35 TB/s): "
          + ("not measured" if share is None else f"{100 * share:.1f}% of the bound")
          + f"; slot pass (search, memset, slots) {slot_us:.1f} us; device operations a "
          f"call {ops_new:.1f}, the former add {ops_old:.1f}")
    if dev and ops_new > ops_old:
        raise AssertionError(f"union-add launches {ops_new} device operations a call, "
                             f"the former add {ops_old}")
    return {"launches": {"union_add": 1}, "numbers": {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "former_ms": statistics.median(turns["former"]),
        "bound_ms": bound_ms, "bound_by": by, "block_us": block_us, "slot_us": slot_us,
        "share": share, "ops": ops_new, "former_ops": ops_old,
    }}


def union_add_phase(card) -> dict:
    """Phase 23 in its own process (`python3 chip_smoke.py --phase23`).
    Returns its record (launches and numbers)."""
    t0 = time.perf_counter()
    rec = phase_process("phase23", 300)
    print(f"[phase23] phase wall {time.perf_counter() - t0:.1f} s (its own process)")
    return rec


# Phase 24: spgemm's fine-branch output pass at the SP2 step's sizes, in its
# own process (`python3 chip_smoke.py --phase24`).


def fine_epilogue_path(card) -> dict:
    """Phase 24's work, in this process: the output pass at the
    b3_sp2.planned step's capacities (262 144 slots of 32 x 32, 172 000
    valid, 26 600 accumulator blocks; alpha -1 and beta 2 on the card)
    against its plain version and the former passes, bit for bit; call
    times in turns with the plain version; device time of the pass and of
    its slot map against the pass's byte bound; device operations a call."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
    from hierarchical_block_sparse_lib_tpu_torch.kernels.fine_epilogue import (
        fine_epilogue,
        fine_epilogue_reference,
    )

    # The yardstick the tests share (tests/former_fine_output.py, no jax).
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from former_fine_output import bits, former_output, sp2_step_operands

    ct, ids, acc, pos = sp2_step_operands(torch.device("cuda"), seed=24)
    alpha, beta = torch.tensor(-1.0, device="cuda"), torch.tensor(2.0, device="cuda")
    args = (ct, ids, alpha, acc, pos, beta)
    torch.cuda.synchronize()
    reset_counts()
    got = fine_epilogue(*args)
    torch.cuda.synchronize()
    launched({"fine_epilogue": 1}, "the SP2 step's output pass")
    plain = fine_epilogue_reference(*args)
    err = float((got - plain).abs().max())
    if not torch.equal(bits(got), bits(plain)):
        raise AssertionError("fine epilogue kernel differs from its plain version at the SP2 step")
    del plain
    if not torch.equal(bits(got), bits(former_output(ct.transpose(-1, -2).contiguous(),
                                                     ids, alpha, acc, pos, beta))):
        raise AssertionError("fine epilogue kernel differs from the former passes at the SP2 step")
    n_valid, n_acc = int((ids != SENTINEL).sum()), int((pos < ids.shape[0]).sum())
    print(f"[phase24] SP2 step output ({ids.shape[0]} slots, {n_valid} valid, {n_acc} "
          f"accumulator blocks): kernel bitwise equal to the plain version and the former "
          f"passes; max abs err {err:.3e}")
    del got
    ms, plain_ms, four = alternate(lambda: fine_epilogue(*args),
                                   lambda: fine_epilogue_reference(*args))
    print(f"[time] {card}: fine epilogue at the SP2 step, median of 7, in turns plain, kernel, "
          f"kernel, plain: kernel {four[0]:.3f} / {four[1]:.3f} ms, plain (the former passes) "
          f"{four[2]:.3f} / {four[3]:.3f} ms; one-call library: none (no torch call "
          f"transposes, scales and gathers into given slots at once)")
    reps = 20
    dev = device_profile("fine epilogue at the SP2 step", lambda: fine_epilogue(*args), reps,
                         card)
    old = device_profile("former passes at the SP2 step",
                         lambda: fine_epilogue_reference(*args), reps, card)
    pass_us = per_call_us(dev, reps, "fine_epilogue_kernel")
    map_us = per_call_us(dev, reps) - pass_us
    old_us = per_call_us(old, reps)
    ops_new = sum(n for _, n in dev.values()) / reps
    ops_old = sum(n for _, n in old.values()) / reps
    # The pass reads C's valid slots and the landing accumulator blocks and
    # writes every slot; ids and the slot map are ~0.1% of it.
    block = ct[0].numel() * ct.element_size()
    pass_bytes = (n_valid + n_acc + ids.shape[0]) * block
    bound_ms, by = bound(0, pass_bytes)
    share = bound_ms * 1e3 / pass_us if pass_us else None
    print(f"[phase24] {card}: output pass {pass_us:.1f} us a call against its byte bound "
          f"{bound_ms * 1e3:.1f} us ({n_valid} C blocks and {n_acc} accumulator blocks read, "
          f"{ids.shape[0]} written, {pass_bytes / 1e9:.3f} GB at 3.35 TB/s): "
          + ("not measured" if share is None else f"{100 * share:.1f}% of the bound")
          + f"; slot map (memset, inversion) {map_us:.1f} us; device operations a call "
          f"{ops_new:.1f}, the former passes {ops_old:.1f} ({old_us:.1f} us of device time)")
    if dev and ops_new > 4:
        raise AssertionError(f"the output pass launches {ops_new} device operations a call")
    return {"launches": {"fine_epilogue": 1}, "numbers": {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": by, "pass_us": pass_us, "map_us": map_us, "share": share, "ops": ops_new,
        "former_ops": ops_old, "former_us": old_us,
    }}


def fine_epilogue_phase(card) -> dict:
    """Phase 24 in its own process (`python3 chip_smoke.py --phase24`).
    Returns its record (launches and numbers)."""
    t0 = time.perf_counter()
    rec = phase_process("phase24", 300)
    print(f"[phase24] phase wall {time.perf_counter() - t0:.1f} s (its own process)")
    return rec


# Phase 25: the truncation's two passes at the SP2 step's sizes, in its own
# process (`python3 chip_smoke.py --phase25`).


def truncate_path(card) -> dict:
    """Phase 25's work, in this process: the truncation at the
    b3_sp2.planned step's capacities (262 144 slots of 32 x 32, 172 000
    valid, a threshold keeping ~24 000, cap 65 536) against the plain
    compaction given the same keep, bit for bit, and against the former
    chain; call times in turns with the former chain; device time of each
    pass against their byte bound; device operations a call."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
    from hierarchical_block_sparse_lib_tpu_torch.kernels import truncate as tk
    from hierarchical_block_sparse_lib_tpu_torch.ops.norms import squared_threshold
    from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import (
        compact_reference,
        keep_reference,
        truncate,
        truncate_reference,
    )

    # The yardstick the tests share (tests/former_truncate.py, no jax).
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from former_truncate import bits, former_truncate, sp2_step_matrix

    cap = 65_536
    a, tau = sp2_step_matrix(torch.device("cuda"), seed=25)
    torch.cuda.synchronize()
    reset_counts()
    got, kept = truncate(a, tau, cap=cap)
    torch.cuda.synchronize()
    launched({"truncate": 2}, "the SP2 step's truncation")
    n2, keep = tk.block_norms_keep(a.ids, a.data, squared_threshold(tau, torch.float32))
    want, want_kept = compact_reference(a, keep, cap)
    if not (torch.equal(got.ids, want.ids) and torch.equal(bits(got.data), bits(want.data))
            and torch.equal(got.nnz, want.nnz) and torch.equal(kept, want_kept)):
        raise AssertionError("truncate kernels differ from the plain compaction at the SP2 step")
    former, former_kept = former_truncate(a, tau, cap=cap)
    n2_64 = a.data.double().square().sum(dim=(1, 2))
    t2 = float(squared_threshold(tau, torch.float32))
    differ = keep != keep_reference(a, tau)
    far = (n2_64 - t2).abs() > 8 * torch.finfo(torch.float32).eps * t2
    if bool((differ & far).any()):
        raise AssertionError("the norm pass keeps or drops a block far from tau^2 unlike the "
                             "former chain")
    rel = float(((n2.double() - n2_64).abs() / n2_64.clamp(min=1e-300))[a.ids != SENTINEL].max())
    if rel > 1e-6:
        raise AssertionError(f"the norm pass's norms are {rel:.3e} from a float64 sum (> 1e-6)")
    n_valid, n_kept = int((a.ids != SENTINEL).sum()), int(kept)
    n_differ = int(differ.sum())
    if n_differ == 0 and not (torch.equal(got.ids, former.ids)
                              and torch.equal(bits(got.data), bits(former.data))):
        raise AssertionError("same keep as the former chain, other result")
    # The error against the plain version where every keep decision agrees;
    # else against the plain compaction of the kernel's keep, the blocks
    # then sitting in other slots.
    plain = truncate_reference(a, tau, cap=cap)[0] if n_differ == 0 else want
    if not torch.equal(got.ids, plain.ids):
        raise AssertionError("truncate kernels keep other ids than the plain version")
    err = float((got.data.double() - plain.data.double()).abs().max())
    yardstick = "the plain version" if n_differ == 0 else "the plain compaction of its keep"
    print(f"[phase25] SP2 step truncation ({a.cap} slots, {n_valid} valid, {n_kept} kept, cap "
          f"{cap}): bitwise equal to the plain compaction given the kernel's keep; max abs err "
          f"against {yardstick} {err:.3e}; norms within {rel:.2e} of a float64 sum (limit "
          f"1e-6); {n_differ} keep decisions differ from the former chain's, each within 8 ulps "
          f"of tau^2" + ("; result bitwise equal to the former chain's" if n_differ == 0 else ""))
    del want, former, plain, n2_64
    ms, former_ms, four = alternate(lambda: truncate(a, tau, cap=cap),
                                    lambda: former_truncate(a, tau, cap=cap))
    print(f"[time] {card}: truncation at the SP2 step, median of 7, in turns former, kernels, "
          f"kernels, former: kernels {four[0]:.3f} / {four[1]:.3f} ms, the former chain "
          f"{four[2]:.3f} / {four[3]:.3f} ms; one-call library: none (no torch call ranks and "
          f"gathers kept blocks into given slots)")
    reps = 20
    dev = device_profile("truncation at the SP2 step", lambda: truncate(a, tau, cap=cap), reps,
                         card)
    old = device_profile("the former chain at the SP2 step",
                         lambda: former_truncate(a, tau, cap=cap), reps, card)
    norms_us = per_call_us(dev, reps, "truncate_norms_kernel")
    compact_us = per_call_us(dev, reps, "truncate_compact_kernel")
    old_us = per_call_us(old, reps)
    ops_new = sum(n for _, n in dev.values()) / reps
    ops_old = sum(n for _, n in old.values()) / reps
    # The two passes' bound: the norm pass reads the valid blocks, the
    # compaction the kept ones and writes every output slot; ids, keep
    # bytes and counts are ~0.3%.  The truncation's own floor skips the
    # second read of the kept blocks (a one-pass design).
    block = a.data[0].numel() * a.data.element_size()
    pass_bytes = (n_valid + min(n_kept, cap) + cap) * block
    bound_ms, by = bound(0, pass_bytes)
    floor_ms, _ = bound(0, (n_valid + cap) * block)
    passes_us = norms_us + compact_us
    share = bound_ms * 1e3 / passes_us if passes_us else None
    floor_share = floor_ms * 1e3 / passes_us if passes_us else None
    print(f"[phase25] {card}: norm pass {norms_us:.1f} us + compaction {compact_us:.1f} us a "
          f"call against the two passes' byte bound {bound_ms * 1e3:.1f} us ({n_valid} valid "
          f"blocks and {min(n_kept, cap)} kept blocks read, {cap} slots written, "
          f"{pass_bytes / 1e9:.3f} GB at 3.35 TB/s): "
          + ("not measured" if share is None else
             f"{100 * share:.1f}% of that bound, {100 * floor_share:.1f}% of the truncation's "
             f"floor {floor_ms * 1e3:.1f} us (the kept blocks not read again)")
          + f"; device operations a call {ops_new:.1f}, the former chain {ops_old:.1f} "
          f"({old_us:.1f} us of device time)")
    if dev and ops_new > 4:
        raise AssertionError(f"the truncation launches {ops_new} device operations a call")
    return {"launches": {"truncate": 2}, "numbers": {
        "ms": ms, "former_ms": former_ms, "bound_ms": bound_ms, "bound_by": by,
        "norms_us": norms_us, "compact_us": compact_us, "passes_us": passes_us, "share": share,
        "ops": ops_new, "former_ops": ops_old, "former_us": old_us, "differ": n_differ,
        "norm_rel_err": rel, "max_abs_err": err, "floor_ms": floor_ms, "floor_share": floor_share,
    }}


def truncate_phase(card) -> dict:
    """Phase 25 in its own process (`python3 chip_smoke.py --phase25`).
    Returns its record (launches and numbers)."""
    t0 = time.perf_counter()
    rec = phase_process("phase25", 300)
    print(f"[phase25] phase wall {time.perf_counter() - t0:.1f} s (its own process)")
    return rec


# Phase 26: the fine kernel at the B3 cells' products, in its own process
# (`python3 chip_smoke.py --phase26`).

# The two products: grid, A's band half-width and kept share (X: ~34
# blocks a row; Z: ~137), A's capacity, B (X again, or a dense T), the
# output capacity and the engines' row caps (PERF.md §5-§6).
FINE_CELLS = {
    "sp2 X.X": dict(nb=832, half=24, keep=0.68, cap_a=65_536, dense_b=False, cap_b=65_536,
                    out_cap=262_144, row_caps=(128, 1_024), alpha=-1.0),
    "ns Z.T": dict(nb=416, half=68, keep=1.0, cap_a=131_072, dense_b=True, cap_b=262_144,
                   out_cap=262_144, row_caps=(512, 512), alpha=1.0),
}


def padded_matrix(ids, nb, b, cap, gen):
    """Block matrix on the card: the sorted `ids` of an nb x nb grid, N(0,1)
    blocks, SENTINEL ids and zero blocks up to capacity `cap`."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch import SENTINEL, BlockMatrix

    n = ids.shape[0]
    full = torch.full((cap,), SENTINEL, dtype=torch.int32, device=DEVICE)
    full[:n] = torch.as_tensor(ids, dtype=torch.int32, device=DEVICE)
    data = torch.zeros((cap, b, b), device=DEVICE)
    data[:n] = torch.randn((n, b, b), generator=gen, device=DEVICE)
    return BlockMatrix(ids=full, data=data, nnz=torch.tensor(n, dtype=torch.int32, device=DEVICE),
                       n_rows=nb * b, n_cols=nb * b, block_size=b)


def plain_by_rows(A, B, out_ids, nb, row_caps, alpha, max_pairs=1 << 20):
    """`fine_spgemm_reference` of A B over groups of C rows (so its gathered
    pairs stay within a few GB): (max |C| of the valid slots, the C blocks
    ``[n_valid, b, b]``)."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch import SENTINEL
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf

    n_valid = int((out_ids != SENTINEL).sum())
    n_a = int((A.ids != SENTINEL).sum())
    pairs = n_a * min(row_caps[0], nb)  # a bound: A's entries times the row cap
    step = max(1, nb * max_pairs // max(pairs, 1))
    parts = []
    for r0 in range(0, nb, step):
        keys = torch.tensor([r0 * nb, min(r0 + step, nb) * nb], dtype=torch.int32, device=DEVICE)
        a0, a1 = torch.searchsorted(A.ids, keys).tolist()
        o0, o1 = torch.searchsorted(out_ids[:n_valid], keys).tolist()
        if o1 == o0:
            continue
        parts.append(pf.fine_spgemm_reference(
            A.ids[a0:a1], A.data[a0:a1], B.ids, B.data, out_ids[o0:o1], nb, nb, nb, o1 - o0,
            row_caps[0], row_caps[1], precision="highest", block_size=A.block_size,
            alpha=alpha))
    want = torch.cat(parts)
    if want.shape[0] != n_valid:
        raise AssertionError(f"plain version covers {want.shape[0]} of {n_valid} slots")
    return want


def fine_cells_path(card) -> dict:
    """Phase 26's work, in this process: an SP2 X.X step and a Newton-Schulz
    Z.T step at the B3 cells' sizes and capacities (832^2 and 416^2 grids
    of 32 x 32 blocks, X banded with ~34 blocks a row, Z with ~137 and T
    dense, the engines' output capacity and row caps), where `launch_shape`
    must pick the narrow shape: one launch each (counted), held against the
    plain version at TOL["highest"] of the largest element, SENTINEL slots
    zero, the wide shape bitwise equal to it, and both shapes' times."""
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

    b, narrow = 32, pf.NARROW[(32, "highest")]
    wide = pf.shapes(b, "highest")[0]
    numbers, launches = {}, 0
    for name, c in FINE_CELLS.items():
        nb = c["nb"]
        gen = torch.Generator(device=DEVICE).manual_seed(26)
        rng = np.random.default_rng(26)
        i, j = np.divmod(np.arange(nb * nb), nb)
        band = (np.abs(i - j) <= c["half"]) & ((rng.random(nb * nb) < c["keep"]) | (i == j))
        A = padded_matrix(np.flatnonzero(band), nb, b, c["cap_a"], gen)
        B = padded_matrix(np.arange(nb * nb), nb, b, c["cap_b"], gen) if c["dense_b"] else A
        pc, oc, _, _ = plan_spgemm_ex(A, B)
        out_cap, row_caps = c["out_cap"], c["row_caps"]
        plan = hbsm.make_fine_plan(A, B, pc, out_cap, row_caps)
        shape = pf.launch_shape(b, "highest", out_cap, nb, nb, B.ids.shape[0])
        if shape != narrow:
            raise AssertionError(f"{name}: launch_shape picks {shape}, not {narrow}")
        kc = pf.launch_config(b, "highest", row_caps[0], shape)["kc"]
        args = (A.ids, A.data, B.ids, B.data, plan.out_ids, nb, nb, nb, out_cap, *row_caps)
        kw = dict(precision="highest", block_size=b, alpha=c["alpha"], tables=plan.tables)
        torch.cuda.synchronize()
        reset_counts()
        got = pf.fine_spgemm(*args, **kw)
        torch.cuda.synchronize()
        launched({"fine_spgemm": 1}, f"{name} at the cell's size")
        launches += 1
        with launch_shape_forced(wide):
            same = torch.equal(pf.fine_spgemm(*args, **kw), got)
        if not same:
            raise AssertionError(f"{name}: the wide shape differs from the narrow one")
        want = plain_by_rows(A, B, plan.out_ids, nb, row_caps, c["alpha"])
        err = rel_err(got[:oc], want)
        if not err <= TOL["highest"]:
            raise AssertionError(f"{name}: kernel vs plain rel err {err:.3e} > {TOL['highest']}")
        if torch.count_nonzero(got[oc:]) != 0:
            raise AssertionError(f"{name}: SENTINEL slots not zero")
        del want
        a_rows = (plan.tables[0][1:] - plan.tables[0][:-1]).double()
        _, _, prec, at, bt = pf._operands(A.data, B.data, b, "highest", c["alpha"])
        times = alternate(
            lambda: pf.launch(plan.out_ids, plan.tables, at, bt, out_cap, nb, nb, row_caps[0],
                              prec),
            lambda: pf.launch(plan.out_ids, plan.tables, at, bt, out_cap, nb, nb, row_caps[0],
                              prec, shape=wide))
        window = min(pf.col_window(nb, B.ids.shape[0], b), pf.SPAN)
        print(f"[phase26] {name}: {int(A.nnz)} x {int(B.nnz)} blocks, {pc} products into {oc} "
              f"of {out_cap} slots, A rows {float(a_rows.mean()):.1f} on average (k-chunk {kc}), "
              f"windows of {window} columns: one launch in the narrow shape {narrow}; "
              f"kernel-vs-plain rel err {err:.3e} (limit {TOL['highest']}); the wide shape "
              f"{wide} bitwise equal; {card}: narrow {times[2][0]:.3f} / {times[2][1]:.3f} ms, "
              f"wide {times[2][2]:.3f} / {times[2][3]:.3f} ms (in turns wide, narrow, narrow, "
              f"wide)")
        numbers[name] = dict(rel_err=err, pairs=pc, slots=oc, kc=kc, window=window,
                             narrow_ms=times[0], wide_ms=times[1])
        del A, B, plan, got, at, bt
        torch.cuda.empty_cache()
    return {"launches": {"fine_spgemm": launches}, "numbers": numbers}


def fine_cells_phase(card) -> dict:
    """Phase 26 in its own process (`python3 chip_smoke.py --phase26`).
    Returns its record (launches and numbers)."""
    t0 = time.perf_counter()
    rec = phase_process("phase26", 600)
    print(f"[phase26] phase wall {time.perf_counter() - t0:.1f} s (its own process)")
    return rec


def phase_main(phase: str) -> int:
    """`python3 chip_smoke.py --phase21`, `--phase22`, `--phase23`,
    `--phase24`, `--phase25` or `--phase26`: that phase alone (phase 21's
    and 23's to 26's kernels built if they are not), its last line one JSON
    object (phase 21's and 23's to 26's launches and numbers, phase 22's
    wall time)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

    if phase == "--phase21":
        _build.load_all(["gemm_rows", "norms", "gemm_stream"])
    if phase == "--phase23":
        _build.load_all(["gemm_fine", "union_add"])
    if phase == "--phase24":
        _build.load_all(["fine_epilogue"])
    if phase == "--phase25":
        _build.load_all(["truncate"])
    if phase == "--phase26":
        _build.load_all(["gemm_fine"])
    card = card_line()
    print(card)
    paths = {"--phase21": wide_leaf_path, "--phase22": lambda _: members_path(),
             "--phase23": union_add_path, "--phase24": fine_epilogue_path,
             "--phase25": truncate_path, "--phase26": fine_cells_path}
    print(json.dumps(paths[phase](card)))
    return 0


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
                     "micro_fine", "union_add", "fine_epilogue", "truncate"])
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s")
    for name, (secs, log) in sorted(_build.build_logs.items()):
        print(f"[build] nvcc {name}: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {line.strip()}")
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
        launch_config,
        shapes,
    )

    for b in (16, 32, 64):  # at B2's B row cap, 44
        for prec in ("highest", "high", "default"):
            for shape in shapes(b, prec):
                print(f"[build] fine_spgemm b={b} {prec} {shape}: {launch_config(b, prec, 44, shape)}")
    tile_kernel_report()
    fine_kernel_report()

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
    b2_launches = launched({"fine_spgemm": 1, "union_add": 1},
                           "B2 chain (fine_matmul, fine_add, fine_scale)")
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
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf

    _, _, prec, at, bt = pf._operands(Af.data, Af.data, b, "highest", 0.5)
    fdev = device_profile("fine_spgemm at B2 (highest)",
                          lambda: pf.launch(plan.out_ids, plan.tables, at, bt, oc, Af.nb_rows,
                                            Af.nb_cols, mbr, prec), 10, card, unit="launch")
    fine_tb = tile_bounds(flops, 2 * Af.data.numel() * 4 + oc * b * b * 4,
                          per_call_us(fdev, 10, "fine_spgemm_kernel"))
    shape = pf.launch_shape(b, "highest", oc, Af.nb_rows, Af.nb_cols, Af.ids.shape[0])
    print(f"[B2] fine_spgemm_kernel (3xTF32, {shape[0]} threads, {shape[1]} an SM) device "
          f"{'not measured' if fine_tb['device_ms'] is None else '%.3f ms' % fine_tb['device_ms']}"
          f" a launch (the FFMA design before it: 0.846-0.893 ms); 3xTF32 bound "
          f"{fine_tb['bound_route_ms']:.3f} ms ({fine_tb['route_bound_by']}): "
          f"{pct(fine_tb['share_route'])}; FP32 bound {fine_tb['bound_fp32_ms']:.3f} ms: "
          f"{pct(fine_tb['share_fp32'])}")
    del at, bt
    b2 = (A, Af, plan, pc, oc, (mbr, mcr))  # phase 15's kpack and spmm (0.1 GB)
    del Af, plan, A
    torch.cuda.empty_cache()

    # Phase 6: the graft entry's step.
    graft_step()

    # Phases 7 and 8: the B3 path, then its kernels alone and the times.
    A3, prof, plans, b3_launches, b3_scan = b3_path()
    entries, _ = b3_kernels_and_times(A3, prof, plans, card)

    # Phase 9: purification against the spectral projector (the port's
    # acceptance check).
    from hierarchical_block_sparse_lib_tpu_torch.scripts.acceptance import b3_purification

    b3_purification()

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

    # Phase 18, last: the distributed path on 8 logical shards, B5 at full
    # size.  Its profiles record ~5 500 launches a call; run before phase
    # 14, they left phase 14's next profile empty.
    p18 = distribution_phase(card)

    # Phase 19: the entry points: the acceptance checks in process, then the
    # bench in a subprocess (CUDA events, no profiler).
    p19 = entry_points_phase(card)

    # Phase 20: the eight ablation scripts, each in a subprocess.
    torch.cuda.empty_cache()
    p20 = ablation_phase(card)

    # Phase 21: the row-panel kernel at leaf 256, in a subprocess.
    p21 = wide_leaf_phase(card)

    # Phase 22: the members the surface walk requires, in a subprocess.
    members_phase()

    # Phase 23: the union-add kernel at the B2 chain's add, in a subprocess.
    p23 = union_add_phase(card)
    u = p23["numbers"]
    entries["union_add"] = dict(
        max_abs_err=u["max_abs_err"], ms=u["ms"], plain_ms=u["plain_ms"], bound=(u["bound_ms"], u["bound_by"]),
        library_ms=None, device_ms=u["block_us"] / 1e3 if u["block_us"] else None,
    )

    # Phase 24: spgemm's fine-branch output pass at the SP2 step, in a subprocess.
    p24 = fine_epilogue_phase(card)
    f = p24["numbers"]
    entries["fine_epilogue"] = dict(
        max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
        bound=(f["bound_ms"], f["bound_by"]), library_ms=None,
        device_ms=f["pass_us"] / 1e3 if f["pass_us"] else None,
    )

    # Phase 25: the truncation's two passes at the SP2 step, in a subprocess.
    p25 = truncate_phase(card)
    t = p25["numbers"]
    entries["truncate"] = dict(
        max_abs_err=t["max_abs_err"], ms=t["ms"], plain_ms=t["former_ms"], bound=(t["bound_ms"], t["bound_by"]),
        library_ms=None, device_ms=t["passes_us"] / 1e3 if t["passes_us"] else None,
    )

    # Phase 26: the fine kernel at the B3 cells' products, in a subprocess.
    p26 = fine_cells_phase(card)

    entries["fine_spgemm"] = dict(
        max_abs_err=fine_err, ms=fine_ms, plain_ms=fine_plain_ms,
        bound=fine_bound, library_ms=None,
    )
    launches = dict(
        b3_launches, fine_spgemm=fine_launches + p26["launches"]["fine_spgemm"], groups_spgemm=b1_launches + b4_groups,
        gather_gemm_accumulate_stream=b2t_launches + purify_launches,
        gather_gemm_accumulate=v1_launches, union_add=b2_launches["union_add"],
        fine_epilogue=0, truncate=p25["launches"]["truncate"], **micro_launches,
    )
    launches["rows_spgemm"] += b4_rows
    for name, n16 in p16.items():
        launches[name] += n16
    for name, n17 in p17.items():
        launches[name] += n17
    for name, n18 in p18.items():
        launches[name] += n18
    for name, n19 in p19.items():
        launches[name] += n19
    for name, n20 in p20.items():
        launches[name] += n20
    for name, n21 in p21.items():
        launches[name] += n21
    print(f"[launches] gather_gemm_accumulate_stream: {b2t_launches} on B2-tile128 + "
          f"{purify_launches} in purify on B3; rows_spgemm: {b3_launches['rows_spgemm']} on "
          f"B3 + {b4_rows} on B4 (phase 15) + {p16['rows_spgemm']} with triu (phase 16: syrk "
          f"and the symmetric B3 path); norms_and_keep: {b3_launches['norms_and_keep']} on B3 "
          f"+ {p16['norms_and_keep']} (phase 16); fine_spgemm: {fine_launches} on B2 + "
          f"{p26['launches']['fine_spgemm']} at the B3 cells' products (phase 26) + "
          f"{p16['fine_spgemm']} through the class (phase 16); fine_epilogue: "
          f"{p16['fine_epilogue']} through the class (phase 16) and the acceptance's fine-branch "
          f"products (phase 19); union_add: "
          f"{b2_launches['union_add']} in the B2 chain + {p16['union_add']} in syrk (phase 16) "
          f"and those in the phases below; truncate: {p25['launches']['truncate']} at the SP2 "
          f"step (phase 25), two a norms_and_keep launch and two the subtree truncation in "
          f"the phases below; phase 17 (SpAMM, aligned, "
          f"models, subtree, demo): {p17}; phase 18 (distribution at B5): {p18}; phase 19 "
          f"(acceptance and bench): {p19}; phase 20 (the ablation scripts): {p20}; phase 21 "
          f"(leaf 256: B4, B4full, B5): {p21}")
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
    phase = sys.argv[1:]
    sys.exit(phase_main(phase[0])
             if phase in (["--phase21"], ["--phase22"], ["--phase23"], ["--phase24"],
                          ["--phase25"], ["--phase26"])
             else main())
