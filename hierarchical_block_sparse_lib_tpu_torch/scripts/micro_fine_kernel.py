"""Micro-benchmarks of the fine-leaf multiply on one CUDA card: the
counterpart of ``scripts/micro_fine_kernel.py``.

  E1a  `micro` "wide": sum over R reps of [32, LA]^T [32, LB] at LA = LB =
       832 (26 blocks of 32, the B2 mean panel), "highest" and "default",
       against one torch.matmul of the R reps stacked along K.
  E1b  `micro` "quad": the same sum (on the TPU in 128x128 tiles), at 896.
  E2   `micro` "flatten": the flat [8, 128] relayout of 16 sub-blocks of a
       128x128 tile per rep.
  E5   torch gather of flat [P, 8, 128] blocks by a permutation.
  E8   canonical [cap, 32, 32] -> quad tiles [cap/4, 32, 128], with and
       without the payload transpose; the flat [cap, 8, 128] copy.
  E9   depth-bucketed gather-add C[s] = sum_d P[src[s, d]], DMAX masked
       gathers, depths drawn from B2's histogram.

Each kernel is held against its plain version on the same inputs, then
timed in turns with it and with its one-call library equivalent where
there is one (CUDA events, `utils/profiling.py::in_turns`), so that every
factor comes from one run; each rate is printed beside the card's name
and power limit.  Run on a CUDA card:

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.micro_fine_kernel

`main(device="cpu", sizes=TINY)` runs every step at a small size on the
CPU (the plain versions; no time is measured there).
"""

from __future__ import annotations

import dataclasses
import statistics

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
    _ieee_fp32_matmul,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import (
    bound,
    card_line,
    card_time_ms,
    in_turns,
    log,
)

# Kernel vs plain version, relative to max|plain| over every returned
# tensor.  "highest": f32 sums in another order.  "default": both round
# the same operands to bf16 and sum exact products in f32 in another
# order (the tensor cores' f32 accumulation is not IEEE-sequential).
TOL = {"highest": 1e-5, "default": 1e-4}
# B2's output slots by number of products, 1..8 (the JAX script's E9).
B2_DEPTHS = np.array([93165, 59692, 25763, 8177, 2053, 422, 80, 12])


@dataclasses.dataclass(frozen=True)
class Sizes:
    R: int = mf.REPS  # micro's reps
    LA: int = 832  # E1a panel lanes (26 blocks of 32)
    LAQ: int = 896  # E1b/E2 lanes (7 quads)
    P: int = 1 << 17  # E5 blocks
    CAP: int = 13108  # E8 blocks (B2's cap, a multiple of 4)
    OC: int = 189364 // 2  # E9 output slots (half of B2's)
    DMAX: int = 8  # E9 depth buckets


TINY = Sizes(R=3, LA=256, LAQ=128, P=64, CAP=16, OC=32)


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def header(device) -> str:
    """Log and return the card line; fail on a CUDA device without a card
    (a measurement never falls back to the CPU)."""
    if on_card(device):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: these micro-benchmarks measure the card")
        line = card_line()
    else:
        line = f"{device}: no card, times not measured"
    log(f"card: {line}")
    return line


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def _tensors(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def check_and_time(name, kernel_fn, plain_fn, device, tol, bnd, library_fn=None):
    """Hold kernel_fn()'s tensors against plain_fn()'s within `tol`
    relative to max|plain| (0: bitwise), then, on the card, time the
    kernel, the plain version and the one-call library yardstick in turns
    (`in_turns`: in that order, then in reverse).  Returns a record: ms,
    plain_ms and library_ms the medians of the two turns, `four` (kernel,
    kernel, plain, plain) and `library_two`."""
    got, want = _tensors(kernel_fn()), _tensors(plain_fn())
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want) or 1.0
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    if not (abs_err / scale <= tol and (tol or bitwise)):
        raise AssertionError(f"{name}: kernel vs plain rel err {abs_err / scale:.3e} > {tol}")
    rec = dict(name=name, max_abs_err=abs_err, rel_err=abs_err / scale, bitwise=bitwise,
               ms=None, plain_ms=None, four=None, library_ms=None, library_two=None,
               bound_ms=bnd[0], bound_by=bnd[1])
    if on_card(device):
        fns = {"kernel": kernel_fn, "plain": plain_fn}
        if library_fn is not None:
            fns["library"] = library_fn
        t = in_turns(fns)
        rec["ms"], rec["plain_ms"] = statistics.median(t["kernel"]), statistics.median(t["plain"])
        rec["four"] = (*t["kernel"], *t["plain"])
        if library_fn is not None:
            rec["library_two"] = t["library"]
            rec["library_ms"] = statistics.median(t["library"])
    return rec


def log_record(rec, rate: str = "") -> None:
    four = rec["four"]
    times = ("kernel not measured" if four is None else
             f"kernel {four[0]:.4f} / {four[1]:.4f} ms, plain {four[2]:.4f} / {four[3]:.4f} ms")
    lib = ("" if rec["library_two"] is None else
           f", library {rec['library_two'][0]:.4f} / {rec['library_two'][1]:.4f} ms")
    log(f"E[{rec['name']}]: {times}{lib}{rate}; bound {rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}); kernel vs plain max abs err {rec['max_abs_err']:.3e} "
        f"(rel {rec['rel_err']:.3e})")


def stacked_matmul(at, bp, reps: int, precision: str):
    """micro's library yardstick: one matmul of the reps stacked along K,
    [LA, 32 R] @ [32 R, LB], TF32 off at "highest", bf16 at "default"."""
    s = torch.from_numpy(mf.rep_scales(reps)).to(at.device)
    a = (at[None] * s[:, None, None]).reshape(32 * reps, -1).T.contiguous()
    b = bp.repeat(reps, 1)
    if precision == "default":
        a, b = a.bfloat16(), b.bfloat16()

    def run():
        with _ieee_fp32_matmul(a.device):
            return torch.matmul(a, b)

    return run


def run_micro(name, at, bp, mode, precision, sizes, device):
    """One `micro` experiment: the kernel against its plain version, times,
    bound and library time."""
    la, lb = at.shape[1], bp.shape[1]
    acc_bytes = 4 * max(la, 256) * max(lb, 128)
    if mode == "flatten":
        bnd = bound(2 * 128 * 128 * sizes.R, acc_bytes)
        lib = None
    else:
        flops = 2 * la * lb * 32 * sizes.R
        bnd = bound(flops, 4 * 32 * (la + lb) + acc_bytes,
                    "bf16" if precision == "default" else "fp32")
        lib = stacked_matmul(at, bp, sizes.R, precision)
    rec = check_and_time(
        name, lambda: mf.micro(at, bp, mode, precision, sizes.R),
        lambda: mf.micro_reference(at, bp, mode, precision, sizes.R),
        device, TOL[precision], bnd, lib,
    )
    rate = ""
    if rec["ms"] is not None:
        if mode == "flatten":
            rate = f" ({rec['ms'] / sizes.R * 1e3:.3f} us per rep)"
        else:
            rate = (f" ({flops / rec['ms'] / 1e9:.2f} TFLOP/s; library "
                    f"{flops / rec['library_ms'] / 1e9:.2f} TFLOP/s)")
    log_record(rec, rate)
    return rec


def time_op(name, fn, device, nbytes, what: str):
    """Run a torch op once, then time it on the card: a record with its
    rate over `nbytes` moved (read + written)."""
    fn()
    ms, _ = card_time_ms(fn, device)
    bnd = bound(0, nbytes)
    rate = "" if ms is None else f" -> {nbytes / ms / 1e6:.0f} GB/s"
    log(f"{name}: {fmt_ms(ms)} for {nbytes / 1e9:.3f} GB {what}{rate}; "
        f"bound {bnd[0]:.4f} ms (bytes)")
    return dict(name=name, ms=ms, nbytes=nbytes, bound_ms=bnd[0])


def main(device="cuda", sizes: Sizes = Sizes()) -> dict:
    """Run E1a, E1b, E2, E5, E8 and E9; returns name -> record."""
    card = header(device)
    rng = np.random.default_rng(0)

    def operand(cols):
        x = (rng.standard_normal((32, cols)) * 0.1).astype(np.float32)
        return torch.from_numpy(x).to(device)

    at, bp = operand(sizes.LA), operand(sizes.LA)
    atq, bpq = operand(sizes.LAQ), operand(sizes.LAQ)
    recs = {}
    for prec in ("highest", "default"):
        recs[f"E1a wide {prec}"] = run_micro(f"E1a wide {prec}", at, bp, "wide", prec, sizes,
                                             device)
        recs[f"E1b quad {prec}"] = run_micro(f"E1b quad {prec}", atq, bpq, "quad", prec, sizes,
                                             device)
    recs["E2 flatten"] = run_micro("E2 flatten", atq, bpq, "flatten", "highest", sizes, device)

    g = torch.Generator(device=device).manual_seed(0)
    blk = 8 * 128 * 4
    # E5: gather of flat [P, 8, 128] blocks.
    src = torch.randn((sizes.P, 8, 128), generator=g, device=device)
    perm = torch.randperm(sizes.P, generator=g, device=device)
    recs["E5"] = time_op("E5 flat gather", lambda: src[perm], device, 2 * sizes.P * blk,
                         "read + written")

    # E8: canonical -> quad-tile relayout.
    cap = sizes.CAP
    blocks = torch.randn((cap, 32, 32), generator=g, device=device)
    permb = torch.randperm(cap, generator=g, device=device)

    def pack(transpose):
        def run():
            d = blocks[permb]
            if transpose:
                d = d.transpose(1, 2)
            return d.reshape(cap // 4, 4, 32, 32).transpose(1, 2).reshape(cap // 4, 32, 128)
        return run

    recs["E8 pack"] = time_op("E8 pack (no transpose)", pack(False), device, 2 * cap * blk,
                              "read + written")
    recs["E8 packT"] = time_op("E8 pack (with transpose)", pack(True), device, 2 * cap * blk,
                               "read + written")
    recs["E8 flat"] = time_op("E8 flat reshape (a view; timed as its copy)",
                              lambda: blocks.reshape(cap, 8, 128).clone(), device,
                              2 * cap * blk, "read + written")
    del blocks, permb

    # E9: fused depth-bucketed gather-add over the E5 pool.
    oc, dmax = sizes.OC, sizes.DMAX
    depth = rng.choice(np.arange(1, 9), oc, p=B2_DEPTHS / B2_DEPTHS.sum())
    valid = np.arange(dmax)[None, :] < depth[:, None]
    srcs = np.where(valid, rng.integers(0, sizes.P, (oc, dmax)), sizes.P)  # pad -> zero block
    srcs = torch.from_numpy(srcs).to(device)

    def gather_add():
        dz = torch.cat([src, torch.zeros((1, 8, 128), device=device)])
        out = dz[srcs[:, 0]]
        for k in range(1, dmax):
            out = out + dz[srcs[:, k]]
        return out

    useful = float(valid.sum()) * blk
    recs["E9"] = time_op(f"E9 gather-add (Dmax={dmax}, {oc} slots)", gather_add, device,
                         useful + oc * blk, "useful read + written")
    log(f"card: {card}")
    return recs


if __name__ == "__main__":
    main()
