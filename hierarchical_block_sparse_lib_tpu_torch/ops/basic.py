"""Add / scale / transpose, the union merge, the planned add and the
block-triangle filters (port of ``ops/basic.py``): the structural-union
tree walk becomes a merge of two sorted id lists, transpose an id remap
plus a batched axis swap, and `triu`/`tril` a stable compaction."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    compact_sorted,
    first_of_run,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


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
    with span("hbsm.add"):
        if (a.n_rows, a.n_cols) != (b.n_rows, b.n_cols):
            raise ValueError("shape mismatch")
        if a.block_size != b.block_size:
            raise ValueError("block_size mismatch")
        cap = cap if cap is not None else a.cap + b.cap
        ids = torch.cat([a.ids, b.ids])
        data = torch.cat([a.data * _scalar(alpha, a.data), b.data * _scalar(beta, b.data)])
        with span("hbsm.union"):
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
    with span("hbsm.scale"):
        return a.with_data(a.data * _scalar(alpha, a.data))


def union_merge(c_id: torch.Tensor, acc_ids: torch.Tensor, out_cap: int):
    """Union structure of two SENTINEL-padded sorted id arrays: returns
    (out_ids, seg, pos_acc, n_unique), int32, where seg/pos_acc map each
    input row to its union slot (SENTINEL rows -> slot `out_cap`; valid
    rows past the capacity keep their slot number, >= out_cap, as in the
    reference, and are dropped where the slots are used).

    One stable argsort: each input element's union slot comes back
    through the inverse permutation, an int scatter."""
    with span("hbsm.union"):
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


@dataclass(frozen=True)
class AddPlan:
    """Precomputed union structure for `add_planned`: valid while both
    operands keep exactly the id arrays it was built from (data may
    change freely).  The add then costs one gather of each operand's
    blocks and the staleness check: no sort, no structural pass."""

    out_ids: torch.Tensor  # int32[cap] union ids, sorted, SENTINEL padded
    slot_in: torch.Tensor  # int32[capA+capB] input row -> union slot
    nnz: torch.Tensor  # int32[] union size (before the clamp: > cap drops)
    a_ids: torch.Tensor  # int32[capA] the operand ids the plan was built for
    b_ids: torch.Tensor  # int32[capB]


def make_add_plan(a_ids: torch.Tensor, b_ids: torch.Tensor, cap: int) -> AddPlan:
    """Union-structure plan for ``add_planned`` (one argsort, on the ids'
    device)."""
    out_ids, seg, pos_acc, nnz = union_merge(a_ids, b_ids, cap)
    return AddPlan(
        out_ids=out_ids, slot_in=torch.cat([seg, pos_acc]), nnz=nnz,
        a_ids=a_ids, b_ids=b_ids,
    )


def gather_slots(slot: torch.Tensor, m: BlockMatrix, cap: int, factor=1.0) -> torch.Tensor:
    """factor * m's block for every one of `cap` union slots, zero where m
    has none; `slot` maps m's rows to union slots (>= cap: none).  The
    slot map is inverted by a small int scatter (slot `cap` is the trash
    row), then m's blocks move by one gather: no float scatter-add."""
    src = torch.full((cap + 1,), m.cap, dtype=torch.int64, device=m.device)
    src[slot.long().clamp(max=cap)] = torch.arange(m.cap, device=m.device)
    src = src[:cap]
    blocks = m.data[src.clamp(max=m.cap - 1)]
    if not (isinstance(factor, (int, float)) and float(factor) == 1.0):
        blocks = blocks * _scalar(factor, blocks)
    return torch.where((src < m.cap)[:, None, None], blocks, 0)


def add_planned(a: BlockMatrix, b: BlockMatrix, plan: AddPlan, alpha=1.0, beta=1.0):
    """C = alpha*A + beta*B at a precomputed union structure
    (`make_add_plan` on these operands' exact ids).  Returns (C, overflow):
    overflow is True when the union exceeded the plan's capacity or when
    either operand's ids left the planned structure or hold a duplicate
    (a stale plan puts blocks in wrong slots: never silent).

    The reference scatter-adds both operands into the union; here each
    union slot gathers its at most one block of each operand through the
    inverted slot map, so no float accumulate runs on the device."""
    with span("hbsm.union"):
        cap = plan.out_ids.shape[0]
        if plan.slot_in.shape[0] != a.cap + b.cap:
            raise ValueError(
                f"plan built for capA+capB={plan.slot_in.shape[0]}, got {a.cap}+{b.cap}"
            )
        mismatch = torch.zeros((), dtype=torch.bool, device=a.device)
        for m, want in ((a, plan.a_ids), (b, plan.b_ids)):
            if m.ids.shape != want.shape:  # a capacity change counts as drift
                mismatch = torch.ones_like(mismatch)
            else:
                mismatch = mismatch | torch.any(m.ids != want)
            # One block per slot holds only for sorted unique ids.
            mismatch = mismatch | torch.any((m.ids[1:] == m.ids[:-1]) & m.valid_mask()[1:])
        out_data = (
            gather_slots(plan.slot_in[: a.cap], a, cap, alpha)
            + gather_slots(plan.slot_in[a.cap:], b, cap, beta)
        ).to(a.dtype)
        c = BlockMatrix(
            ids=plan.out_ids, data=out_data, nnz=torch.clamp(plan.nnz, max=cap),
            n_rows=a.n_rows, n_cols=a.n_cols, block_size=a.block_size,
        )
        return c, (plan.nnz > cap) | mismatch


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
