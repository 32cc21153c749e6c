"""Second round of fine-leaf micro-benchmarks on one CUDA card: the
counterpart of ``scripts/micro_fine_kernel2.py``.

  E2x  `e2`: [32, 32] -> [8, 128] row-major by its three recipes, each
       bitwise equal to ``x.reshape(8, 128)``.
  E3   `e3`: R3 = 4096 adds of one [8, 128] block into data-dependent
       slots, against one ``index_add_``, and the projection to B2's 336k
       products.
  E12  `e12`: the whole inner loop per A block, NBROW = 26 (the B2 mean
       panel) leaf products of 32x32 per A block for RA = 256 A blocks,
       "highest" and "default", with and without the data-dependent
       slots, and the projection to B2's 13 107 A blocks.
  E11  torch's payload transpose + flat relayout of [cap, 32, 32], and the
       flat copy alone.

Run on a CUDA card:

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.micro_fine_kernel2

`main(device="cpu", sizes=TINY)` runs every step at a small size on the
CPU (no time is measured there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf
from hierarchical_block_sparse_lib_tpu_torch.scripts.micro_fine_kernel import (
    TOL,
    check_and_time,
    header,
    log_record,
    time_op,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import bound, log

B2_PAIRS = 335_999  # the configured B2's leaf products (plan_spgemm)
B2_A_BLOCKS = 13_107  # its stored blocks
# The tier's route in micro_fine.cu: 3xTF32 mma.sync at "highest", one
# bf16 pass at "default".
ROUTE = {"highest": "tf32x3", "default": "bf16"}


@dataclasses.dataclass(frozen=True)
class Sizes:
    R3: int = 4096  # E3 adds
    NBROW: int = 26  # E12 panel blocks (B2 mean)
    RA: int = 256  # E12 A blocks
    CAP: int = 13108  # E11 blocks


TINY = Sizes(R3=64, RA=4, CAP=16)


def main(device="cuda", sizes: Sizes = Sizes()) -> dict:
    """Run E2x, E3, E12 and E11; returns name -> record."""
    card = header(device)
    rng = np.random.default_rng(0)
    acc_bytes = 4 * mf.ACC_ROWS * 128
    recs = {}

    x = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32)).to(device)
    for variant in mf.VARIANTS:
        rec = check_and_time(
            f"E2x {variant}", lambda v=variant: mf.e2(x, v),
            lambda v=variant: mf.e2_reference(x, v), device, 0.0, bound(0, 2 * 4096),
            lambda: x.reshape(8, 128).clone(),
        )
        if not torch.equal(mf.e2_reference(x, variant), x.reshape(8, 128)):
            raise AssertionError(f"e2 {variant} differs from x.reshape(8, 128)")
        log_record(rec, " (equal to x.reshape(8, 128) bitwise; library: its .clone())")
        recs[f"E2x {variant}"] = rec

    # E3: the data-dependent accumulate.
    r3 = sizes.R3
    idx = torch.from_numpy(rng.integers(0, 500, r3).astype(np.int32)).to(device)
    v = torch.from_numpy(rng.standard_normal((8, 128)).astype(np.float32)).to(device)
    n_slots = mf.ACC_ROWS // 8
    vexp = v.reshape(1, 1024).expand(r3, 1024)
    rec = check_and_time(
        "E3", lambda: mf.e3(idx, v), lambda: mf.e3_reference(idx, v), device, 0.0,
        bound(r3 * 1024, 4 * r3 + 4096 + acc_bytes),
        lambda: torch.zeros((n_slots, 1024), device=device).index_add_(0, idx, vexp),
    )
    rate = ""
    if rec["ms"] is not None:
        per = rec["ms"] / r3
        rate = (f" ({per * 1e6:.1f} ns/add, {r3 / rec['ms'] / 1e3:.1f} M adds/s; "
                f"{B2_PAIRS} adds -> {B2_PAIRS * per:.3f} ms; index_add_ "
                f"{rec['library_ms'] / r3 * 1e6:.1f} ns/add)")
    log_record(rec, rate + " (bitwise equal to the plain version)")
    recs["E3"] = rec

    # E12: the inner loop per A block.
    ra, nbrow = sizes.RA, sizes.NBROW
    a_wide = torch.from_numpy(
        (rng.standard_normal((ra, 32, 128)) * 0.1).astype(np.float32)).to(device)
    panel = torch.from_numpy(
        (rng.standard_normal((8 * nbrow, 128)) * 0.1).astype(np.float32)).to(device)
    idx12 = torch.from_numpy(rng.integers(0, 500, ra * nbrow).astype(np.int32)).to(device)
    leaf = ra * nbrow
    flops = 2 * 32**3 * leaf
    nbytes = 4 * (ra * 32 * 32 + panel.numel() + idx12.numel()) + acc_bytes
    for prec in ("highest", "default"):
        for do_adds in (True, False):
            name = f"E12 {prec} adds={do_adds}"
            rec = check_and_time(
                name, lambda p=prec, d=do_adds: mf.e12(a_wide, panel, idx12, p, d),
                lambda p=prec, d=do_adds: mf.e12_reference(a_wide, panel, idx12, p, d),
                device, TOL[prec], bound(flops, nbytes, ROUTE[prec]),
            )
            rate = ""
            if rec["ms"] is not None:
                per_blk = rec["ms"] / ra
                rate = (f" ({per_blk * 1e6:.0f} ns/A-block, {rec['ms'] / leaf * 1e6:.2f} ns "
                        f"per leaf product, {flops / rec['ms'] / 1e9:.2f} TFLOP/s; "
                        f"{B2_A_BLOCKS} A blocks -> {B2_A_BLOCKS * per_blk:.3f} ms)")
            log_record(rec, rate)
            recs[name] = rec

    # E11: payload transpose + flat relayout as torch ops.
    cap = sizes.CAP
    g = torch.Generator(device=device).manual_seed(0)
    blocks = torch.randn((cap, 32, 32), generator=g, device=device)
    recs["E11 payloadT+flat"] = time_op(
        "E11 payloadT+flat", lambda: blocks.transpose(1, 2).reshape(cap, 8, 128), device,
        2 * cap * 4096, "read + written")
    recs["E11 flat"] = time_op(
        "E11 flat only (a view; timed as its copy)",
        lambda: blocks.reshape(cap, 8, 128).clone(), device, 2 * cap * 4096, "read + written")
    log(f"card: {card}")
    return recs


if __name__ == "__main__":
    main()
