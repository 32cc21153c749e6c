"""A later routed stage's accumulate two ways, on one CUDA card: the
counterpart of ``scripts/bench_scatter_accum.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.bench_scatter_accum

At B2's routed-stage shapes (a union of 4 415 blocks, a stage product of
1 231, b = 128, seed 0):

  gather-add   the generic formulation: the compact product gathered to
               the union through an inverse slot map (`index_select`, slot
               1 231 a zero block), then added to the accumulator
  scatter-add  ``c.index_add_(0, idx, prod)``, in place, with c reused
               across calls

measured in turns (`scripts/ablation.py`), beside two floors at the
card's 3.35 TB/s: the union buffer read and written once, and the touched
blocks only.  The indices are unique, so `index_add_` is deterministic
here, and the two results must be equal.  No kernel of the port runs
here: both are torch's ops, as the JAX script's are XLA's.

`main(device="cpu", union=64, stage=20, b=16)` runs both at a small size
on the CPU, where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import HBM_BYTES, log


def operands(union: int, stage: int, b: int, device):
    """(c0, prod, idx, inv) from the JAX script's numpy calls: the
    accumulator, the stage product, its sorted unique union slots, and the
    inverse map (union slot -> stage slot, `stage` for none)."""
    rng = np.random.default_rng(0)
    c0 = rng.standard_normal((union, b, b)).astype(np.float32)
    prod = rng.standard_normal((stage, b, b)).astype(np.float32)
    idx = np.sort(rng.choice(union, stage, replace=False)).astype(np.int32)
    inv = np.full((union,), stage, np.int32)
    inv[idx] = np.arange(stage, dtype=np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (c0, prod, idx, inv))


def main(argv=None, device=None, union: int = 4415, stage: int = 1231, b: int = 128) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("bench_scatter_accum: no CUDA device; nothing to run")
        return 2
    run = Run("bench_scatter_accum", dev)
    c0, prod, idx, inv = operands(union, stage, b, dev)
    prod_pad = torch.cat([prod, torch.zeros((1, b, b), device=dev)])
    idx64 = idx.long()

    def gather_add(c):
        return c + torch.index_select(prod_pad, 0, inv)

    def scatter_add(c):
        return c.index_add_(0, idx64, prod)

    want = gather_add(c0)
    got = scatter_add(c0.clone())
    run.check("gather-add and scatter-add equal", torch.equal(got, want))
    del want, got
    c = c0.clone()
    run.measure({"gather-add": lambda: gather_add(c0), "scatter-add": lambda: scatter_add(c)})
    union_bytes = union * b * b * 4
    floors = {"union_ms": 2 * union_bytes / HBM_BYTES * 1e3,
              "touched_ms": 2 * stage * b * b * 4 / HBM_BYTES * 1e3}
    run.counters.update(union=union, stage=stage, b=b, union_gb=union_bytes / 1e9)
    log(f"floors at {HBM_BYTES / 1e12:.2f} TB/s: union buffer {union_bytes / 1e9:.2f} GB read "
        f"and written {floors['union_ms']:.3f} ms; touched blocks only "
        f"{floors['touched_ms']:.3f} ms")
    g, s = run.parts["gather-add"], run.parts["scatter-add"]
    if g["ms"] is not None:
        log(f"scatter/gather: {s['ms'] / g['ms']:.2f}x (call); gather-add "
            f"{floors['union_ms'] / g['ms']:.1%} of the union floor, scatter-add "
            f"{floors['touched_ms'] / s['ms']:.1%} of the touched floor")
    run.difference("scatter-add - gather-add", ["scatter-add"], ["gather-add"])
    return run.finish(floors=floors)


if __name__ == "__main__":
    sys.exit(main())
