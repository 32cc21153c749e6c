"""Plain reference of the near-dense product C = A @ B over random
block-sparse A and B, and the inputs both sides get (the chain's
generator: independent structures, N(0, 1) blocks).

The reference works out everything the program derives: the product's
support from the two block masks, the pairs, C's block ids, and C's
values as a dense product at its mode's precision, one slab of
`SLAB_ELEMENTS` output elements at a time so that it fits beside the
checked answers at 32768^2.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts
from benchmark.reference import common
# The chain's inputs, and its comparison of an answer's ids, blocks and counters.
from benchmark.reference.chain import Member, answer, compare, make_inputs  # noqa: F401

# Output elements of one slab of the dense product: 1 GiB in float64.
SLAB_ELEMENTS = 2**27


def structure(m: Member) -> dict:
    """Pairs, product blocks and C's block ids, from the masks alone.
    (The chain's `structure` gives the ids of A @ B together with A's.)"""
    nb = m.n // m.b
    ma, mb = counts.block_mask(m.a_ids, nb), counts.block_mask(m.b_ids, nb)
    prod = counts.product_mask(ma, mb)
    return dict(pairs=counts.pairs(ma, mb), out_blocks=int(prod.sum()),
                ids=counts.mask_ids(prod))


def work(cfg: dict, m: Member, ref: dict) -> dict:
    """FLOPs of the call's leaf products (2 * b^3 a pair) and its least
    bytes: A and B read once, C written once."""
    return dict(pairs=ref["pairs"], flops=counts.gemm_flops(ref["pairs"], m.b),
                bytes=counts.block_bytes(m.a_ids.size + m.b_ids.size + ref["ids"].size, m.b))


def reference(cfg: dict, m: Member, mode: str = "f64") -> dict:
    """C's ids and blocks, with the counters, at `mode`'s precision."""
    # No TF32 in any library call: the control rounds its operands itself.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nb, b = m.n // m.b, m.b
    dt = common.work_dtype(mode)
    s = structure(m)
    ids = s["ids"]
    a = common.dense(m.a_ids, m.a_data, nb, dt)
    bm = common.dense(m.b_ids, m.b_data, nb, dt)
    data = torch.empty((ids.size, b, b), dtype=dt, device=m.a_data.device)
    cols = ids % nb
    width = max(1, SLAB_ELEMENTS // (m.n * b))  # block columns a slab
    for j0 in range(0, nb, width):
        j1 = min(j0 + width, nb)
        sel = np.flatnonzero((cols >= j0) & (cols < j1))
        if sel.size == 0:
            continue
        c = common.matmul(a, bm[:, j0 * b:j1 * b], mode).view(nb, b, j1 - j0, b)
        t = torch.as_tensor(ids[sel], device=c.device)
        data[torch.as_tensor(sel, device=c.device)] = c[t // nb, :, t % nb - j0, :]
        del c
    return dict(ids=ids, data=data, pairs=s["pairs"], out_blocks=s["out_blocks"])

