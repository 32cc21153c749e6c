"""Add / scale / transpose, the union merge and the block-triangle
filters (port of ``ops/basic.py``): the structural-union tree walk
becomes a merge of two sorted id lists, transpose an id remap plus a
batched axis swap, and `triu`/`tril` a stable compaction."""

from __future__ import annotations

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    compact_sorted,
    first_of_run,
)


def _scalar(x, like: torch.Tensor):
    """`x` (a number or a 0-dim tensor) as a factor for `like`: a tensor
    is cast to `like`'s dtype on its own device (a 0-dim tensor scales a
    tensor on any device without a host sync); a number stays a number."""
    return x.to(like.dtype) if isinstance(x, torch.Tensor) else x


def add_with_info(
    a: BlockMatrix,
    b: BlockMatrix,
    alpha=1.0,
    beta=1.0,
    cap: int | None = None,
):
    """C = alpha*A + beta*B by structural union.

    Returns (C, overflow): `overflow` is True iff the union exceeded
    `cap` and trailing (highest-id) blocks were dropped.
    """
    if (a.n_rows, a.n_cols) != (b.n_rows, b.n_cols):
        raise ValueError("shape mismatch")
    if a.block_size != b.block_size:
        raise ValueError("block_size mismatch")
    cap = cap if cap is not None else a.cap + b.cap
    ids = torch.cat([a.ids, b.ids])
    data = torch.cat([a.data * _scalar(alpha, a.data), b.data * _scalar(beta, b.data)])
    out_ids, out_data, nnz = compact_sorted(ids, data, cap)
    c = BlockMatrix(
        ids=out_ids, data=out_data, nnz=torch.clamp(nnz, max=cap),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )
    return c, nnz > cap


def add(a: BlockMatrix, b: BlockMatrix, alpha=1.0, beta=1.0, cap: int | None = None):
    """C = alpha*A + beta*B.  Output capacity defaults to cap(A)+cap(B)
    (never overflows); with a bounded `cap`, use `add_with_info` to
    detect dropped blocks."""
    return add_with_info(a, b, alpha=alpha, beta=beta, cap=cap)[0]


def scale(a: BlockMatrix, alpha) -> BlockMatrix:
    """A <- alpha * A.  Structure is preserved (even for alpha == 0)."""
    return a.with_data(a.data * _scalar(alpha, a.data))


def union_merge(c_id: torch.Tensor, acc_ids: torch.Tensor, out_cap: int):
    """Union structure of two SENTINEL-padded sorted id arrays: returns
    (out_ids, seg, pos_acc, n_unique), int32, where seg/pos_acc map each
    input row to its union slot (SENTINEL rows -> slot `out_cap`; valid
    rows past the capacity keep their slot number, >= out_cap, as in the
    reference, and are dropped where the slots are used).

    One stable argsort: each input element's union slot comes back
    through the inverse permutation, an int scatter."""
    both = torch.cat([c_id, acc_ids])
    order = torch.argsort(both, stable=True)
    uni = both[order]
    validu = uni != SENTINEL
    firstu = first_of_run(uni) & validu
    slotu = torch.where(validu, torch.cumsum(firstu, 0) - 1, out_cap)
    out_ids = torch.full((out_cap + 1,), SENTINEL, dtype=torch.int32, device=c_id.device)
    out_ids[slotu.clamp(max=out_cap)] = uni.to(torch.int32)
    n_unique = firstu.sum().to(torch.int32)
    # Original element order[i] sits at sorted position i.
    slot_orig = torch.empty_like(slotu)
    slot_orig[order] = slotu
    slot_orig = slot_orig.to(torch.int32)
    n = c_id.shape[0]
    return out_ids[:out_cap], slot_orig[:n], slot_orig[n:], n_unique


def filter_blocks(a: BlockMatrix, keep: torch.Tensor) -> BlockMatrix:
    """Drop stored blocks where `keep` (bool[cap]) is False.  Capacity is
    unchanged and survivors stay sorted at the front: a stable compaction
    without a sort (ids are sorted), whose block tensor moves by one
    gather; source index `cap` reads an appended SENTINEL/zero row."""
    keep = keep & a.valid_mask()
    cap = a.cap
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, cap)
    src = torch.full((cap + 1,), cap, dtype=torch.int64, device=a.device)
    src[slot] = torch.arange(cap, device=a.device)
    src = src[:cap]
    pad = src == cap
    srcc = src.clamp(max=cap - 1)
    return BlockMatrix(
        ids=torch.where(pad, SENTINEL, a.ids[srcc]).to(torch.int32),
        data=torch.where(pad[:, None, None], 0, a.data[srcc]),
        nnz=keep.sum().to(torch.int32),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )


def triu(a: BlockMatrix, strict: bool = False) -> BlockMatrix:
    """Keep blocks with block_row <= block_col (< if `strict`)."""
    brow, bcol = a.ids // a.nb_cols, a.ids % a.nb_cols
    return filter_blocks(a, (brow < bcol) if strict else (brow <= bcol))


def tril(a: BlockMatrix, strict: bool = False) -> BlockMatrix:
    """Keep blocks with block_row >= block_col (> if `strict`)."""
    brow, bcol = a.ids // a.nb_cols, a.ids % a.nb_cols
    return filter_blocks(a, (brow > bcol) if strict else (brow >= bcol))


def symmetrize_upper(a: BlockMatrix, cap: int):
    """(S, overflow): S is the upper block triangle of A mirrored below
    (S_ij = A_ij for i <= j, S_ji = A_ij^T), at capacity `cap`; one
    concatenation and one `compact_sorted`.

    Diagonal blocks are averaged with their own transpose, so S is
    symmetric element for element: a diagonal block of an upper-only
    product is symmetric only to rounding (its (a, b) and (b, a) entries
    sum the same products in another order)."""
    brow, bcol = a.ids // a.nb_cols, a.ids % a.nb_cols
    valid = a.valid_mask()
    up = valid & (brow <= bcol)
    strict = valid & (brow < bcol)
    diag = valid & (brow == bcol)
    ids_up = torch.where(up, a.ids, SENTINEL)
    ids_lo = torch.where(strict, bcol * a.nb_rows + brow, SENTINEL)
    data_up = torch.where(up[:, None, None], a.data, 0)
    data_up = torch.where(
        diag[:, None, None], 0.5 * (data_up + data_up.transpose(-1, -2)), data_up
    )
    data_lo = torch.where(strict[:, None, None], a.data.transpose(-1, -2), 0)
    out_ids, out_data, nnz = compact_sorted(
        torch.cat([ids_up, ids_lo]).to(torch.int32), torch.cat([data_up, data_lo]), cap
    )
    s = BlockMatrix(
        ids=out_ids, data=out_data, nnz=torch.clamp(nnz, max=cap),
        n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
    )
    return s, nnz > cap


def transpose(a: BlockMatrix) -> BlockMatrix:
    """B = A^T: remap ids (brow, bcol) -> (bcol, brow), re-sort, and swap
    the trailing axes of every leaf block in one batched copy."""
    brow = a.ids // a.nb_cols
    bcol = a.ids % a.nb_cols
    new_ids = torch.where(
        a.valid_mask(), bcol * a.nb_rows + brow, SENTINEL
    ).to(torch.int32)
    order = torch.argsort(new_ids, stable=True)
    return BlockMatrix(
        ids=new_ids[order],
        data=a.data[order].transpose(-1, -2).contiguous(),
        nnz=a.nnz,
        n_rows=a.n_cols,
        n_cols=a.n_rows,
        block_size=a.block_size,
    )
