"""Element assembly / extraction (port of ``core/assembly.py``):
one sort-by-block-id plus a segment scatter instead of a per-element
quadtree descent; COO export (`to_coo`, the streamed `to_coo_chunks`)
and random element reads (`get_values`) in the reference's order."""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    check_geometry,
    compact_sorted,
    resolve_device,
    run_slots,
)


def empty(
    n_rows: int,
    n_cols: int,
    block_size: int,
    cap: int,
    dtype=torch.float32,
    device=None,
) -> BlockMatrix:
    """All-zero matrix with storage capacity for `cap` blocks, on the card
    unless `device` names another."""
    check_geometry(n_rows, n_cols, block_size)
    device = resolve_device(device)
    return BlockMatrix(
        ids=torch.full((cap,), SENTINEL, dtype=torch.int32, device=device),
        data=torch.zeros((cap, block_size, block_size), dtype=dtype, device=device),
        nnz=torch.zeros((), dtype=torch.int32, device=device),
        n_rows=n_rows,
        n_cols=n_cols,
        block_size=block_size,
    )


def eye(
    n: int, block_size: int, dtype=torch.float32, cap: int | None = None,
    device=None,
) -> BlockMatrix:
    """Identity matrix: one dense diagonal block per block-row, on the card
    unless `device` names another."""
    check_geometry(n, n, block_size)
    device = resolve_device(device)
    b = block_size
    nb = -(-n // b)
    cap = cap if cap is not None else nb
    ids = torch.full((cap,), SENTINEL, dtype=torch.int32, device=device)
    ids[:nb] = torch.arange(nb, dtype=torch.int32, device=device) * (nb + 1)
    # Trailing diagonal entries past n (a padded edge block) stay zero.
    rows = torch.arange(nb * b, device=device).reshape(nb, b)
    data = torch.zeros((cap, b, b), dtype=dtype, device=device)
    diag = torch.diagonal(data[:nb], dim1=-2, dim2=-1)
    diag.copy_((rows < n).to(dtype))
    return BlockMatrix(
        ids=ids, data=data,
        nnz=torch.full((), nb, dtype=torch.int32, device=device),
        n_rows=n, n_cols=n, block_size=b,
    )


def from_coo(
    rows,
    cols,
    vals,
    n_rows: int,
    n_cols: int | None = None,
    block_size: int = 128,
    cap: int | None = None,
    device=None,
) -> BlockMatrix:
    """Build from COO triplets (duplicate entries sum), on the card unless
    `device` names another.  `vals` is anything numpy can read, or a
    tensor (bfloat16 included).  `cap` defaults to the exact number of
    touched blocks."""
    n_cols = n_rows if n_cols is None else n_cols
    check_geometry(n_rows, n_cols, block_size)
    device = resolve_device(device)
    b = block_size
    nbc = -(-n_cols // b)
    rows = torch.as_tensor(np.asarray(rows), device=device).to(torch.int64)
    cols = torch.as_tensor(np.asarray(cols), device=device).to(torch.int64)
    vals = torch.as_tensor(vals if isinstance(vals, torch.Tensor) else np.asarray(vals), device=device)
    bid = (rows // b) * nbc + cols // b
    if cap is None:
        cap = max(int(torch.unique(bid).numel()), 1)
    order = torch.argsort(bid, stable=True)
    bid_s, rows_s, cols_s, vals_s = bid[order], rows[order], cols[order], vals[order]
    slot, ids, nnz = run_slots(bid_s, cap)
    slot.clamp_(max=cap)
    data = torch.zeros((cap + 1, b, b), dtype=vals.dtype, device=device)
    data.index_put_((slot, rows_s % b, cols_s % b), vals_s, accumulate=True)
    return BlockMatrix(
        ids=ids, data=data[:cap], nnz=nnz,
        n_rows=n_rows, n_cols=n_cols, block_size=block_size,
    )


def from_dense(
    x, block_size: int = 128, cap: int | None = None, threshold: float = 0.0
) -> BlockMatrix:
    """Blockify a dense matrix, storing blocks with frob norm > threshold.
    `x` is a tensor (its device is kept) or anything numpy can read."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    n_rows, n_cols = x.shape
    check_geometry(n_rows, n_cols, block_size)
    b = block_size
    nbr, nbc = -(-n_rows // b), -(-n_cols // b)
    xp = torch.zeros((nbr * b, nbc * b), dtype=x.dtype, device=x.device)
    xp[:n_rows, :n_cols] = x
    blocks = xp.reshape(nbr, b, nbc, b).permute(0, 2, 1, 3).reshape(-1, b, b)
    acc = torch.promote_types(blocks.dtype, torch.float32)
    norms2 = torch.sum(torch.square(blocks.to(acc)), dim=(1, 2))
    keep = norms2 > torch.tensor(threshold, dtype=acc) ** 2
    all_ids = torch.arange(nbr * nbc, dtype=torch.int32, device=x.device)
    ids = torch.where(keep, all_ids, SENTINEL).to(torch.int32)
    blocks = torch.where(keep[:, None, None], blocks, 0)
    if cap is None:
        cap = max(int(keep.sum()), 1)
    out_ids, out_data, nnz = compact_sorted(ids, blocks, cap)
    return BlockMatrix(
        ids=out_ids, data=out_data, nnz=nnz,
        n_rows=n_rows, n_cols=n_cols, block_size=block_size,
    )


def to_dense(a: BlockMatrix) -> torch.Tensor:
    """Densify (the test oracle path)."""
    b = a.block_size
    nbr, nbc = a.nb_rows, a.nb_cols
    valid = a.valid_mask()
    ids = a.ids.to(torch.int64)
    brow = torch.where(valid, ids // nbc, nbr)  # trash row nbr
    bcol = torch.where(valid, ids % nbc, 0)
    grid = torch.zeros((nbr + 1, nbc, b, b), dtype=a.dtype, device=a.device)
    grid.index_put_((brow, bcol), a.data, accumulate=True)
    full = grid[:nbr].permute(0, 2, 1, 3).reshape(nbr * b, nbc * b)
    return full[: a.n_rows, : a.n_cols]


def _coo_of(a: BlockMatrix, ids: torch.Tensor, slot_ok: torch.Tensor):
    """(rows, cols, mask) of every element of the blocks `ids` [m], each
    [m, b, b] int32/bool: `mask` marks elements of blocks with `slot_ok`
    inside the logical bounds; masked-out positions read row = col = 0."""
    b = a.block_size
    ids = ids.to(torch.int64)
    r_in = torch.arange(b, device=ids.device)
    rows = (ids // a.nb_cols)[:, None, None] * b + r_in[None, :, None]
    cols = (ids % a.nb_cols)[:, None, None] * b + r_in[None, None, :]
    mask = (slot_ok & (ids != SENTINEL))[:, None, None] & (rows < a.n_rows) & (cols < a.n_cols)
    rows = torch.where(mask, rows, 0).to(torch.int32)
    cols = torch.where(mask, cols, 0).to(torch.int32)
    return rows, cols, mask


def to_coo(a: BlockMatrix):
    """All stored elements as (rows, cols, vals, mask), each of length
    cap*b*b, in slot order and row-major within a block (the reference's
    order); `mask` marks elements of valid blocks inside the logical
    bounds."""
    ok = torch.ones(a.cap, dtype=torch.bool, device=a.device)
    rows, cols, mask = _coo_of(a, a.ids, ok)
    return rows.reshape(-1), cols.reshape(-1), a.data.reshape(-1), mask.reshape(-1)


def to_coo_chunks(a: BlockMatrix, chunk_blocks: int = 2048, drop_zeros=False):
    """Stream stored elements to the host as (rows, cols, vals) numpy
    chunks of at most `chunk_blocks` blocks each, in `to_coo`'s order.

    Peak host memory is one chunk instead of four cap*b*b arrays.  Chunks
    arrive mask-filtered (padding slots and out-of-bounds elements
    removed, on the device); `drop_zeros` also removes explicit zeros
    inside stored blocks.  numpy has no bfloat16: bf16 values arrive
    widened to float32 (exactly)."""
    nnz = int(a.nnz)
    chunk = min(chunk_blocks, a.cap)
    for s in range(0, nnz, chunk):
        e = min(s + chunk, nnz)
        ok = torch.ones(e - s, dtype=torch.bool, device=a.device)
        rows, cols, mask = _coo_of(a, a.ids[s:e], ok)
        vals = a.data[s:e]
        if drop_zeros:
            mask = mask & (vals != 0)
        if vals.dtype == torch.bfloat16:
            vals = vals.float()
        yield tuple(x[mask].cpu().numpy() for x in (rows, cols, vals))


def get_values(a: BlockMatrix, rows, cols) -> torch.Tensor:
    """Random-access element reads, on `a`'s device: a binary search over
    the sorted ids; elements of absent blocks read 0."""
    rows = torch.as_tensor(np.asarray(rows), device=a.device).to(torch.int64)
    cols = torch.as_tensor(np.asarray(cols), device=a.device).to(torch.int64)
    b = a.block_size
    bid = (rows // b) * a.nb_cols + cols // b
    pos = torch.searchsorted(a.ids.to(torch.int64), bid).clamp_(max=a.cap - 1)
    hit = a.ids[pos].to(torch.int64) == bid
    vals = a.data[pos, rows % b, cols % b]
    return torch.where(hit, vals, 0)
