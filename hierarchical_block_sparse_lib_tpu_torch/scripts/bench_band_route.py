"""B1's product through the dense-band tier against the block path, on one
CUDA card: the counterpart of ``scripts/bench_band_route.py`` (should
`matmul` send banded input to the band tier?).

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.bench_band_route

At B1's leaf-16 input (banded 4096^2, bandwidth 64, seed 0), measured in
turns (`scripts/ablation.py`):

  band_from_blocks   the block matrix to band panels
  band_mm            the banded product (one batched GEMM over the strips)
  band_to_blocks     the band product back to blocks
  band route         all of it for A @ B: both operands packed, the
                     product, the conversion back
  block path         `matmul(A16, A16)`, its host plan included; the
                     backend it resolves to is logged ("fine" at b = 16)

The JAX script's chained `band_mm` row is the CUDA-event time of
`band_mm` here.  Checks: the two products within 1e-5 of each other and
of the float64 product of the dense input (relative to max|C|).

`main(device="cpu", n=512, bw=16)` runs all of it at a small size on the
CPU, where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.bench import rel_err
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_groups import plan_groups
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex, resolve_backend
from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import log

TOL = 1e-5


def main(argv=None, device=None, n: int = 4096, bw: int = 64) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("bench_band_route: no CUDA device; nothing to run")
        return 2
    run = Run("bench_band_route", dev)
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A16 = hbsm.from_coo(r, c, v, n, block_size=16, device=dev)
    pc, oc, mbr, mcr = plan_spgemm_ex(A16, A16)
    gplan = plan_groups(A16, A16) if pc < 16 * max(A16.nb_rows, 1) else None
    backend = resolve_backend(16, A16.dtype, A16.nb_cols, pc, row_caps=(mbr, mcr),
                              group_caps=None if gplan is None else gplan.caps)
    run.counters.update(n=n, bw=bw, blocks=int(A16.nnz), pairs=pc, out=oc, backend=backend)
    log(f"B1 leaf 16 ({n}^2, bw {bw}): {int(A16.nnz)} blocks, {pc} pairs, {oc} output blocks; "
        f"the block path's matmul executes backend = {backend}")
    Ab = hbsm.band_from_blocks(A16, bw)
    Cb = hbsm.band_mm(Ab, Ab)

    def route():
        x, y = hbsm.band_from_blocks(A16, bw), hbsm.band_from_blocks(A16, bw)
        return hbsm.band_to_blocks(hbsm.band_mm(x, y), block_size=16)

    calls = {
        "band_from_blocks": lambda: hbsm.band_from_blocks(A16, bw),
        "band_mm": lambda: hbsm.band_mm(Ab, Ab),
        "band_to_blocks": lambda: hbsm.band_to_blocks(Cb, block_size=16),
        "band route": route,
        "block path": lambda: hbsm.matmul(A16, A16)[0],
    }
    dense = torch.from_numpy(gen.dense_oracle(r, c, v, n)).to(dev).double()
    want = dense @ dense
    del dense
    band = hbsm.to_dense(route())
    block = hbsm.to_dense(calls["block path"]())
    errs = dict(band_vs_f64=rel_err(band, want), block_vs_f64=rel_err(block, want),
                band_vs_block=rel_err(band, block))
    del band, block, want
    run.counters.update(errs)
    for k, e in errs.items():
        run.check(f"{k} within {TOL}", e <= TOL, f"{e:.3e}")
    run.measure(calls)
    run.difference("band route - block path", ["band route"], ["block path"])
    run.difference("band route - its parts (2 packs + mm + unpack)", ["band route"],
                   ["band_from_blocks", "band_from_blocks", "band_mm", "band_to_blocks"])
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
