"""Occupancy-aware leaf-strip packing SpGEMM (port of ``ops/leafpack.py``).

Coarsening small leaves (16/32) into 128-wide tiles pays for every zero
leaf inside a tile (7.0x the honest leaf-pair FLOPs on the B1 band).
This path packs instead:

1. Block rows of the fine matrix are cut into strips of ``f`` leaf rows
   (f * b_fine = 128 rows).
2. Per strip, the occupied leaf columns (union over the strip's rows)
   are packed into a dense ``[128, La*b_fine]`` panel: zero leaves
   between the band's diagonals are never materialised, only the padding
   to the largest strip's La.
3. The matching B leaf rows/cols are gathered into a dense
   ``[La*b_fine, Lc*b_fine]`` panel the same way.
4. ONE batched `torch.bmm` over all strips computes every C leaf of the
   strip: the dense panel product is the sum over k.
5. Panel leaves are scattered back to the exact fine C structure,
   computed at plan time and equal to the pair enumeration's.

The plan self-validates: the operands' id structure is recorded at plan
time and compared on use (``info.plan_mismatch``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    ids_mismatch,
    scalar_factor,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    MultiplyInfo,
    matmul_precision,
)


@dataclass(frozen=True)
class LeafpackPlan:
    """Host-built strip-packing plan (see the module docstring).

    Index tables route missing leaves to the zero slot (index == cap of
    the operand; the multiply appends one zero block), and absent C panel
    leaves to the trash slot ``out_cap``.
    """

    a_gidx: torch.Tensor  # int32[S, f, La]  -> A block index or capA (zero)
    b_gidx: torch.Tensor  # int32[S, La, Lc] -> B block index or capB (zero)
    c_slot: torch.Tensor  # int32[S, f, Lc]  -> C output slot or out_cap
    c_ids: torch.Tensor  # int32[out_cap], sorted, SENTINEL padded
    # Operand structure the plan was built for (self-validation).
    a_ids: torch.Tensor  # int32[capA]
    b_ids: torch.Tensor  # int32[capB]
    n_out: torch.Tensor  # int32[] distinct C blocks
    strips: int = 0  # S
    strip_leaves: int = 8  # f
    la: int = 0  # packed A/k columns per strip
    lc: int = 0  # packed C columns per strip
    out_cap: int = 0
    n_leaf_pairs: int = 0  # honest leaf-GEMM count
    panel_flops: int = 0  # padded panel FLOPs actually run
    block_size: int = 16  # fine leaf size b_fine

    @property
    def inflation(self) -> float:
        """Panel FLOPs / honest leaf-pair FLOPs (1.0 = no padding)."""
        return self.panel_flops / max(1, self.n_leaf_pairs * 2 * self.block_size**3)


def plan_leafpack(
    a: BlockMatrix,
    b: BlockMatrix,
    strip_rows: int = 128,
    max_cols: int | None = None,
) -> LeafpackPlan | None:
    """Host-side exact plan for `leafpack_spgemm` (C = A @ B at fine leaf
    granularity); its tables go to A's device.

    `strip_rows`: strip height in matrix rows.  `max_cols`: applicability
    guard; if a strip needs more than this many packed leaf columns (La
    or Lc), return None (the structure is not strip-local enough; use
    `spgemm` instead).  Defaults to 4096 // block_size (panels up to
    [128, 4096]).
    """
    bf = a.block_size
    if a.block_size != b.block_size or a.n_cols != b.n_rows:
        raise ValueError("operand geometry mismatch")
    f = max(1, strip_rows // bf)
    align = max(1, 128 // bf)  # packed widths in multiples of 128 columns
    if max_cols is None:
        max_cols = max(align, 4096 // bf)

    a_ids = a.ids.cpu().numpy().astype(np.int64)
    b_ids = b.ids.cpu().numpy().astype(np.int64)
    cap_a, cap_b = a.cap, b.cap
    av = a_ids != int(SENTINEL)
    bv = b_ids != int(SENTINEL)
    a_row = np.where(av, a_ids // a.nb_cols, 0)
    a_col = np.where(av, a_ids % a.nb_cols, 0)
    b_row = np.where(bv, b_ids // b.nb_cols, 0)
    b_col = np.where(bv, b_ids % b.nb_cols, 0)
    nbr, nbc_b = a.nb_rows, b.nb_cols
    S = -(-nbr // f)

    # B grouped by block row (sorted ids: rows are contiguous).
    b_valid_idx = np.nonzero(bv)[0]
    b_rows_v = b_row[b_valid_idx]
    b_cols_v = b_col[b_valid_idx]
    b_row_start = np.searchsorted(b_rows_v, np.arange(b.nb_rows + 1))

    a_valid_idx = np.nonzero(av)[0]
    a_rows_v = a_row[a_valid_idx]
    a_cols_v = a_col[a_valid_idx]
    # Sorted A ids: strips are contiguous index ranges.
    strip_start = np.searchsorted(a_rows_v, np.arange(0, (S + 1) * f, f))

    ka_list, cc_list = [], []
    n_leaf_pairs = 0
    for s in range(S):
        sl = slice(strip_start[s], strip_start[s + 1])
        ka = np.unique(a_cols_v[sl])
        # C columns of the strip: union of B-row supports over ka.
        segs = [b_cols_v[b_row_start[k] : b_row_start[k + 1]] for k in ka]
        cc = np.unique(np.concatenate(segs)) if segs else np.empty(0, np.int64)
        ka_list.append(ka)
        cc_list.append(cc)
        if ka.size:
            cnt_a = np.bincount(np.searchsorted(ka, a_cols_v[sl]), minlength=ka.size)
            cnt_b = b_row_start[ka + 1] - b_row_start[ka]
            n_leaf_pairs += int(np.dot(cnt_a, cnt_b))
    La = max((k.size for k in ka_list), default=0)
    Lc = max((c.size for c in cc_list), default=0)
    La = -(-max(La, 1) // align) * align
    Lc = -(-max(Lc, 1) // align) * align
    if La > max_cols or Lc > max_cols:
        return None

    a_gidx = np.full((S, f, La), cap_a, np.int32)
    b_gidx = np.full((S, La, Lc), cap_b, np.int32)
    c_present = np.zeros((S, f, Lc), bool)
    for s in range(S):
        ka, cc = ka_list[s], cc_list[s]
        if ka.size == 0:
            continue
        sl = slice(strip_start[s], strip_start[s + 1])
        r = (a_rows_v[sl] - s * f).astype(np.int64)
        t = np.searchsorted(ka, a_cols_v[sl])
        a_gidx[s, r, t] = a_valid_idx[sl]
        for ti, k in enumerate(ka):
            seg = slice(b_row_start[k], b_row_start[k + 1])
            u = np.searchsorted(cc, b_cols_v[seg])
            b_gidx[s, ti, u] = b_valid_idx[seg]
            # The strip's rows holding leaf (row, k) produce C leaves at
            # every column of B's row k.
            rows_with_k = r[t == ti]
            if rows_with_k.size and u.size:
                c_present[s, rows_with_k[:, None], u[None, :]] = True

    # Exact C structure, sorted.
    ss, rr, uu = np.nonzero(c_present)
    cc_arr = np.zeros((S, Lc), np.int64)
    for s in range(S):
        cc_arr[s, : cc_list[s].size] = cc_list[s]
    cids = (ss * f + rr) * nbc_b + cc_arr[ss, uu]
    order = np.argsort(cids)
    n_out = cids.size
    out_cap = max(1, n_out)
    c_slot = np.full((S, f, Lc), out_cap, np.int32)
    c_slot[ss[order], rr[order], uu[order]] = np.arange(n_out, dtype=np.int32)
    c_ids = np.full((out_cap,), int(SENTINEL), np.int32)
    c_ids[:n_out] = cids[order]

    dev = a.device
    panel_flops = S * 2 * (f * bf) * (La * bf) * (Lc * bf)
    return LeafpackPlan(
        a_gidx=torch.from_numpy(a_gidx).to(dev),
        b_gidx=torch.from_numpy(b_gidx).to(dev),
        c_slot=torch.from_numpy(c_slot).to(dev),
        c_ids=torch.from_numpy(c_ids).to(dev),
        a_ids=a.ids,
        b_ids=b.ids,
        n_out=torch.tensor(n_out, dtype=torch.int32, device=dev),
        strips=S,
        strip_leaves=f,
        la=La,
        lc=Lc,
        out_cap=out_cap,
        n_leaf_pairs=n_leaf_pairs,
        panel_flops=panel_flops,
        block_size=bf,
    )


def leafpack_spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    plan: LeafpackPlan,
    alpha=1.0,
    precision: str = "highest",
):
    """C = alpha * A @ B via strip-packed dense panels (module docstring).

    Returns (C, MultiplyInfo); C has the exact fine-leaf structure the
    pair enumeration would give.  `n_block_pairs`/`n_leaf_multiplies`
    report the honest leaf-GEMM count (the reference's
    no_of_block_multiplies at ITS leaf size).
    """
    bf = a.block_size
    S, f, La, Lc = plan.strips, plan.strip_leaves, plan.la, plan.lc
    mism = ids_mismatch(((a.ids, plan.a_ids), (b.ids, plan.b_ids)))
    acc = torch.promote_types(a.dtype, torch.float32)
    zero = torch.zeros((1, bf, bf), dtype=acc, device=a.device)
    az = torch.cat([a.data.to(acc), zero])
    bz = torch.cat([b.data.to(acc), zero])
    # pa[s, r, t, i, l] -> [S, f*bf (r, i), La*bf (t, l)];
    # pb[s, t, u, l, j] -> [S, La*bf (t, l), Lc*bf (u, j)].
    pa = az[plan.a_gidx.long()].permute(0, 1, 3, 2, 4).reshape(S, f * bf, La * bf)
    pb = bz[plan.b_gidx.long()].permute(0, 1, 3, 2, 4).reshape(S, La * bf, Lc * bf)
    with matmul_precision(precision, a.device):
        pc = torch.bmm(pa, pb)  # [S, (r, i), (u, j)]
    pc = pc * scalar_factor(alpha, pc)
    pc = pc.reshape(S, f, bf, Lc, bf).permute(0, 1, 3, 2, 4).reshape(S * f * Lc, bf, bf)
    out = torch.zeros((plan.out_cap + 1, bf, bf), dtype=acc, device=a.device)
    out[plan.c_slot.reshape(-1).long()] = pc  # absent leaves go to slot out_cap
    c = BlockMatrix(
        ids=plan.c_ids,
        data=out[: plan.out_cap].to(a.dtype),
        nnz=plan.n_out,
        n_rows=a.n_rows,
        n_cols=b.n_cols,
        block_size=bf,
    )
    n_leaf = torch.tensor(plan.n_leaf_pairs, dtype=torch.int32, device=a.device)
    false = torch.zeros((), dtype=torch.bool, device=a.device)
    info = MultiplyInfo(
        n_block_pairs=n_leaf,
        n_out_blocks=plan.n_out,
        pair_overflow=false,
        out_overflow=false,
        row_overflow=false,
        plan_mismatch=mism,
        n_leaf_multiplies=n_leaf,
    )
    return c, info
