"""Add / scale / transpose and the union merge (port of ``ops/basic.py``):
the structural-union tree walk becomes a merge of two sorted id lists,
and transpose an id remap plus a batched axis swap."""

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
