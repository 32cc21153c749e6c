#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the script exits non-zero without its
final line):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the Hopper kernels from the sources in this checkout;
3. kernel vs its plain PyTorch version at small shapes, b in {16, 32, 64}
   x the three precision tiers, on rectangular alpha != 1 operands with
   empty rows, plus the canonical layout and the zero tail;
4. the main path at its configured size, B2: random 16384^2, 5% block
   density, leaf 32, seed 2, through plan_spgemm_ex -> fine_pack ->
   make_fine_plan -> fine_matmul(plan=) -> fine_add -> fine_scale ->
   fine_unpack, held against an f64 dense oracle and the host plan's
   counters, with the kernel's launch count read around it;
5. the kernel vs the plain version at the main path's shapes, and
   bitwise determinism of a repeated planned multiply;
6. CUDA-event times of the planned multiply through the kernel and
   through the plain version.

Prints one JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

KERNEL_SOURCE = "hierarchical_block_sparse_lib_tpu_torch/kernels/csrc/gemm_fine.cu"
KERNEL_REPLACES = "hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_fine.py:450"
TOL = {"highest": 1e-5, "high": 1e-5, "default": 1e-4}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_pattern(nbr, nbc, b, density, seed, empty_rows=(), device="cuda"):
    """Random block-sparse matrix with dense N(0,1) blocks; block rows in
    `empty_rows` hold nothing."""
    import torch

    from hierarchical_block_sparse_lib_tpu_torch import BlockMatrix

    rng = np.random.default_rng(seed)
    n_blocks = max(1, int(round(density * nbr * nbc)))
    ids = np.sort(rng.choice(nbr * nbc, n_blocks, replace=False))
    ids = ids[~np.isin(ids // nbc, empty_rows)].astype(np.int32)
    data = rng.standard_normal((ids.size, b, b)).astype(np.float32)
    return BlockMatrix(
        ids=torch.from_numpy(ids).to(device),
        data=torch.from_numpy(data).to(device),
        nnz=torch.tensor(ids.size, dtype=torch.int32, device=device),
        n_rows=nbr * b, n_cols=nbc * b, block_size=b,
    )


def check_close(name, got, want, tol):
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name}: max abs err {err:.3e} over tol {tol}")
    return err


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
        if b == 32:  # canonical payloads in and out
            kw = dict(precision="highest", alpha=-0.5, tables=plan.tables)
            cargs = (A.ids, A.data, B.ids, B.data) + args[4:]
            err = check_close("canonical", fine_spgemm(*cargs, **kw),
                              fine_spgemm_reference(*cargs, **kw), TOL["highest"])
            print(f"  b=32 canonical layout max_abs_err={err:.3e}")


def cuda_time_ms(fn, warmup=2, reps=7):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), times


def main() -> int:
    import torch

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

    # Phase 2: build.
    t0 = time.perf_counter()
    _build.load("gemm_fine")
    print(f"[build] gemm_fine ready in {time.perf_counter() - t0:.1f} s")
    for name, (secs, log) in _build.build_logs.items():
        print(f"[build] nvcc {name}: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")

    # Phase 3: kernel vs plain version at small shapes.
    print("[small] kernel vs plain version")
    small_shapes()

    # Phase 4: the main path at the configured B2 size.
    n, b, density, seed = 16384, 32, 0.05, 2
    A = random_block_matrix(n, b, density, seed=seed, device="cuda")
    torch.cuda.synchronize()
    fine_spgemm.launches = 0
    t0 = time.perf_counter()
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    Af = hbsm.fine_pack(A)
    plan = hbsm.make_fine_plan(Af, Af, pc, oc, (mbr, mcr))
    C, info = hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan)
    D = hbsm.fine_unpack(hbsm.fine_scale(hbsm.fine_add(C, Af, beta=0.25), 2.0))
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = fine_spgemm.launches
    print(f"[B2] {n}^2 b={b} density={density} seed={seed}: {int(A.nnz)} blocks, "
          f"pairs={pc} out_blocks={oc} row caps=({mbr}, {mcr}); "
          f"chain {main_s:.3f} s (first call), kernel launches={launches}")
    if launches < 1:
        raise AssertionError("the main path did not launch the fine kernel")
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
    print(f"[B2] chain vs f64 oracle: max rel err {rel:.3e}")
    if rel > 1e-5:
        raise AssertionError(f"B2 chain rel err {rel:.3e} > 1e-5")

    # Phase 5: kernel vs plain version at the main path's shapes;
    # determinism of a repeated planned multiply.
    args = (Af.ids, Af.data, Af.ids, Af.data, plan.out_ids, Af.nb_rows,
            Af.nb_rows, Af.nb_cols, oc, mbr, mcr)
    kw = dict(block_size=b, out_layout="flat", alpha=0.5, tables=plan.tables)
    plain = fine_spgemm_reference(*args, **kw)
    max_abs_err = check_close("B2 kernel vs plain", C.data, plain, TOL["highest"])
    del plain
    print(f"[B2] kernel vs plain version: max abs err {max_abs_err:.3e} "
          f"(rtol = atol = {TOL['highest']})")
    C2, _ = hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan)
    if not torch.equal(C.data, C2.data):
        raise AssertionError("repeated planned fine_matmul is not bitwise equal")
    del C2
    print("[B2] repeated planned fine_matmul: bitwise equal")

    # Phase 6: times (CUDA events, median of 7 after 2 warm-up calls),
    # alternating plain, kernel, kernel, plain.
    def kernel_run():
        hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan)

    def plain_run():
        fine_spgemm_reference(*args, **kw)

    plain_a, _ = cuda_time_ms(plain_run)
    kern_a, kern_all = cuda_time_ms(kernel_run)
    kern_b, _ = cuda_time_ms(kernel_run)
    plain_b, plain_all = cuda_time_ms(plain_run)
    kern_ms = statistics.median([kern_a, kern_b])
    plain_ms = statistics.median([plain_a, plain_b])
    flops = 2 * b**3 * pc
    print(f"[time] {card}: planned fine_matmul at B2 (highest), median of 7")
    print(f"[time]   kernel {kern_a:.3f} / {kern_b:.3f} ms  "
          f"-> {flops / kern_ms / 1e6:.1f} GFLOP/s  (runs {kern_all})")
    print(f"[time]   plain  {plain_a:.3f} / {plain_b:.3f} ms  "
          f"-> {flops / plain_ms / 1e6:.1f} GFLOP/s  (runs {plain_all})")
    print(f"[time]   peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    print(json.dumps({"kernels": [{
        "name": "fine_spgemm",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
