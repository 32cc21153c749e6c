"""Capacity management and block-size coarsening (port of
``ops/repack.py``).

`repack` changes the static storage capacity (the canonical sorted
layout makes this a slice or a pad).  `coarsen` merges f x f logical
blocks into one larger block: the bridge from the reference's small
leaves (16/32) to the 128-wide blocks of the row-panel kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    first_of_run,
)


def plan_coarsen(a: BlockMatrix, factor: int) -> int:
    """Host-side exact coarse block count: the tight `cap` for `coarsen`
    (every structural pass scales with capacity, not nnz)."""
    ids = a.ids.cpu().numpy()
    ids = ids[ids != SENTINEL]
    if ids.size == 0:
        return 1
    brow, bcol = ids // a.nb_cols, ids % a.nb_cols
    nbc2 = -(-a.nb_cols // factor)
    return int(np.unique((brow // factor) * nbc2 + (bcol // factor)).size)


def repack(a: BlockMatrix, cap: int) -> BlockMatrix:
    """`a` with storage capacity `cap`: growing pads, shrinking slices.
    Shrinking below nnz drops trailing (highest-id) blocks; check
    ``a.nnz <= cap`` if that matters."""
    if cap == a.cap:
        return a
    if cap > a.cap:
        pad = cap - a.cap
        ids = torch.cat([
            a.ids,
            torch.full((pad,), SENTINEL, dtype=torch.int32, device=a.device),
        ])
        data = torch.cat([
            a.data,
            torch.zeros((pad,) + tuple(a.data.shape[1:]), dtype=a.dtype, device=a.device),
        ])
        nnz = a.nnz
    else:
        ids, data = a.ids[:cap], a.data[:cap]
        nnz = torch.clamp(a.nnz, max=cap)
    return BlockMatrix(
        ids=ids, data=data, nnz=nnz,
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )


def coarsen(
    a: BlockMatrix,
    factor: int,
    cap: int | None = None,
    track_leaves: bool = False,
):
    """Merge factor x factor neighbourhoods of blocks into single blocks of
    size block_size*factor, zero-filling absent children.  `cap` defaults
    to the input capacity (coarsening never increases the block count).

    With `track_leaves=True` returns (matrix, occ) where
    ``occ: bool[cap, factor, factor]`` marks which logical sub-blocks of
    each coarse tile are present."""
    f = factor
    b = a.block_size
    cap2 = cap if cap is not None else a.cap
    dev = a.device
    nbc2 = -(-a.nb_cols // f)
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    new_id = torch.where(
        a.valid_mask(), (brow // f) * nbc2 + (bcol // f), SENTINEL
    ).to(torch.int32)
    order = torch.argsort(new_id, stable=True)
    nid_s = new_id[order]
    valid = nid_s != SENTINEL
    first = first_of_run(nid_s)
    # Padding and slots past the capacity go to the trash slot cap2.
    slot = torch.where(valid, torch.cumsum(first, 0) - 1, cap2).clamp_(max=cap2)
    rf = (brow % f)[order].long()
    cf = (bcol % f)[order].long()
    # Each small block lands at its own (rf, cf) position of its coarse
    # block: valid positions are distinct, so a plain scatter suffices.
    grid = torch.zeros((cap2 + 1, f, f, b, b), dtype=a.dtype, device=dev)
    grid[slot, rf, cf] = a.data[order]
    data = grid[:cap2].permute(0, 1, 3, 2, 4).reshape(cap2, f * b, f * b)
    ids = torch.full((cap2 + 1,), SENTINEL, dtype=torch.int32, device=dev)
    ids[slot] = nid_s
    m = BlockMatrix(
        ids=ids[:cap2], data=data, nnz=(first & valid).sum().to(torch.int32),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=b * f,
    )
    if not track_leaves:
        return m
    occ = torch.zeros((cap2 + 1, f, f), dtype=torch.bool, device=dev)
    occ[slot, rf, cf] = valid
    return m, occ[:cap2]
