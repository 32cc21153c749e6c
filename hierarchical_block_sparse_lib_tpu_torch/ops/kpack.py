"""Packed-contraction SpGEMM for fine leaves (port of ``ops/kpack.py``):
the occupancy path for RANDOM structures at leaves 16/32.

Coarsening B2's leaf-32 blocks into 128-wide tiles pays for every empty
leaf slot of a tile (~100x the honest leaf-pair FLOPs at 5% random),
and strip packing (`ops.leafpack`) does not help: a strip's C-column
union approaches the full width.  This path packs the CONTRACTION axis
per coarse output tile:

1. Coarse output tile (I, J) covers f x f fine leaves (f = tile / b_fine).
   Its contribution is  C_IJ = sum_k A[I, k] @ B[k, J]  over FINE
   contraction indices k with A[I, k] != 0 AND B[k, J] != 0, where
   A[I, k] is a [tile, b_fine] column of f fine leaves and B[k, J] a
   [b_fine, tile] row.
2. The k's that fail either test are never materialised: the panels
   `[tile, Lk*b_fine] @ [Lk*b_fine, tile]` hold only useful k slices.
   Padding left: absent fine leaves within a useful slice (exact zeros)
   and the per-group Lk rounding.
3. One batched `torch.bmm` per tile group computes every output tile:
   the panel product is the k sum.

Tiles are sorted by their packed width |K| and split into `n_groups`
groups, each padded to its largest width; the groups also bound the
gather workspace, since only one group's panels exist at a time.

The plan self-validates against the operands' id structure on use
(`info.plan_mismatch`).  Counters report HONEST fine-leaf multiplies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    MultiplyInfo,
    ids_mismatch,
    matmul_precision,
)


@dataclass(frozen=True)
class KpackPlan:
    """Host-built per-output-tile contraction-packing plan.

    `a_src[g][t, l]` / `b_src[g][t, l]` index the packed A-column / B-row
    arrays (index NA/NB = the all-zero pad slot); `c_slot[g][t]` is the
    output slot of group g's tile t.  Absent fine leaves inside a useful
    k slice are zero in the packed arrays, so the panel product is exact.
    """

    # Per group (tuples of tensors).
    a_src: tuple  # tuple[int32[Tg, Lk_g]]
    b_src: tuple  # tuple[int32[Tg, Lk_g]]
    c_slot: tuple  # tuple[int32[Tg]]
    # Scatter tables building the packed operand arrays from fine data.
    a_scat_col: torch.Tensor  # int32[capA] -> A fine-column slot (NA = pad)
    a_scat_off: torch.Tensor  # int32[capA] -> fine row within the tile row
    b_scat_row: torch.Tensor  # int32[capB] -> B fine-row slot (NB = pad)
    b_scat_off: torch.Tensor  # int32[capB] -> fine col within the tile col
    c_ids: torch.Tensor  # int32[n_tiles] coarse tile ids, sorted
    # Operand structure the plan was built for (self-validation).
    a_ids: torch.Tensor  # int32[capA]
    b_ids: torch.Tensor  # int32[capB]
    n_a_cols: int = 0  # NA
    n_b_rows: int = 0  # NB
    n_tiles: int = 0
    tile: int = 128  # coarse tile size f * b_fine
    leaves: int = 4  # f
    block_size: int = 32  # fine leaf size b_fine
    n_leaf_pairs: int = 0  # honest leaf-GEMM count
    panel_flops: int = 0  # padded panel FLOPs run

    @property
    def inflation(self) -> float:
        """Panel FLOPs / honest leaf-pair FLOPs (1.0 = no padding)."""
        return self.panel_flops / max(1, self.n_leaf_pairs * 2 * self.block_size**3)


def plan_kpack(
    a: BlockMatrix,
    b: BlockMatrix,
    tile: int = 128,
    n_groups: int = 32,
) -> KpackPlan | None:
    """Host-side exact plan for `kpack_spgemm` (C = A @ B with fine leaves
    packed along the contraction per coarse output tile); its tables go
    to A's device.

    Returns None when the fine leaves don't subdivide `tile` (use
    `spgemm` at tile granularity instead).  `n_groups` bounds the
    per-group Lk padding (tiles sorted by packed width, groups of equal
    tile count) and the gather workspace, about
    (n_tiles / n_groups) * tile * Lk_max * 8 bytes.
    """
    bf = a.block_size
    if a.block_size != b.block_size or a.n_cols != b.n_rows:
        raise ValueError("operand geometry mismatch")
    if tile % bf != 0 or tile == bf:
        return None
    f = tile // bf

    a_ids = a.ids.cpu().numpy().astype(np.int64)
    b_ids = b.ids.cpu().numpy().astype(np.int64)
    av = a_ids != int(SENTINEL)
    bv = b_ids != int(SENTINEL)
    nbk = a.nb_cols  # fine contraction width
    nbI = -(-a.nb_rows // f)
    nbJ = -(-b.nb_cols // f)
    ar = np.where(av, a_ids // nbk, 0)
    ac = np.where(av, a_ids % nbk, 0)
    br = np.where(bv, b_ids // b.nb_cols, 0)
    bc = np.where(bv, b_ids % b.nb_cols, 0)

    # Occupied A fine-columns (I, k) and B fine-rows (k, J), sorted.
    a_keys = np.unique(((ar // f) * nbk + ac)[av]) if av.any() else np.empty(0, np.int64)
    b_keys = np.unique((br * nbJ + bc // f)[bv]) if bv.any() else np.empty(0, np.int64)
    NA, NB = a_keys.size, b_keys.size

    # Membership bitmaps for the per-tile k intersection.
    abm = np.zeros((nbI, nbk), bool)
    abm[a_keys // nbk, a_keys % nbk] = True
    bbm = np.zeros((nbk, nbJ), bool)
    bbm[b_keys // nbJ, b_keys % nbJ] = True

    # Enumerate (tile, k) entries, J-major within each I, so tile ids come
    # out sorted.
    tile_keys, tile_cnt, ent_a, ent_b = [], [], [], []
    for I in range(nbI):
        ka = np.nonzero(abm[I])[0]
        if ka.size == 0:
            continue
        JJ, tt = np.nonzero(bbm[ka].T)  # J-major
        if JJ.size == 0:
            continue
        ks = ka[tt]
        uJ, counts = np.unique(JJ, return_counts=True)
        tile_keys.append(I * nbJ + uJ)
        tile_cnt.append(counts)
        ent_a.append(np.searchsorted(a_keys, I * nbk + ks))
        ent_b.append(np.searchsorted(b_keys, ks * nbJ + JJ))
    if not tile_keys:
        return None
    tile_keys = np.concatenate(tile_keys)
    tile_cnt = np.concatenate(tile_cnt).astype(np.int64)
    ent_a = np.concatenate(ent_a).astype(np.int32)
    ent_b = np.concatenate(ent_b).astype(np.int32)
    n_tiles = tile_keys.size
    ent_off = np.concatenate([[0], np.cumsum(tile_cnt)])
    n_leaf_pairs = _count_fine_pairs(a_ids[av], b_ids[bv], nbk, b.nb_cols)

    # Group tiles by packed width; Lk padded to a multiple of f (Lk * bf a
    # multiple of tile) within each group.
    dev = a.device
    order = np.argsort(tile_cnt, kind="stable")
    groups = np.array_split(order, min(n_groups, n_tiles))
    a_src, b_src, c_slot = [], [], []
    panel_flops = 0
    for g in groups:
        if g.size == 0:
            continue
        lk = int(tile_cnt[g].max())
        lk = -(-max(lk, 1) // f) * f
        sa = np.full((g.size, lk), NA, np.int32)
        sb = np.full((g.size, lk), NB, np.int32)
        for t, ti in enumerate(g):
            s = slice(ent_off[ti], ent_off[ti + 1])
            w = ent_off[ti + 1] - ent_off[ti]
            sa[t, :w] = ent_a[s]
            sb[t, :w] = ent_b[s]
        a_src.append(torch.from_numpy(sa).to(dev))
        b_src.append(torch.from_numpy(sb).to(dev))
        # tile_keys is sorted: a tile's slot is its position there.
        c_slot.append(torch.from_numpy(g.astype(np.int32)).to(dev))
        panel_flops += g.size * 2 * tile * (lk * bf) * tile

    # Scatter tables: every valid fine leaf lands in its (I,k) column /
    # (k,J) row slot; padding leaves (all-zero) go to the pad slot.
    a_scat_col = np.where(av, np.searchsorted(a_keys, (ar // f) * nbk + ac), NA)
    b_scat_row = np.where(bv, np.searchsorted(b_keys, br * nbJ + bc // f), NB)

    def t32(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)

    return KpackPlan(
        a_src=tuple(a_src),
        b_src=tuple(b_src),
        c_slot=tuple(c_slot),
        a_scat_col=t32(a_scat_col),
        a_scat_off=t32(np.where(av, ar % f, 0)),
        b_scat_row=t32(b_scat_row),
        b_scat_off=t32(np.where(bv, bc % f, 0)),
        c_ids=t32(tile_keys),
        a_ids=a.ids,
        b_ids=b.ids,
        n_a_cols=NA,
        n_b_rows=NB,
        n_tiles=n_tiles,
        tile=tile,
        leaves=f,
        block_size=bf,
        n_leaf_pairs=int(n_leaf_pairs),
        panel_flops=int(panel_flops),
    )


def _count_fine_pairs(a_ids_v, b_ids_v, a_nbc, b_nbc):
    """Exact fine-granularity pair count (the honest counter): the host
    planner, or without the native library a bincount of B's rows."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    if native.have_native():
        n, _ = native.plan_spgemm(
            np.asarray(a_ids_v, np.int32), np.asarray(b_ids_v, np.int32),
            a_nbc, a_nbc, b_nbc,
        )
        return n
    ac = a_ids_v % a_nbc
    br = b_ids_v // b_nbc
    cnt_b = np.bincount(br, minlength=a_nbc)
    return int(cnt_b[ac].sum())


def kpack_spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    plan: KpackPlan,
    alpha=1.0,
    precision: str = "highest",
    layout: str = "plain",
):
    """C = alpha * A @ B via per-tile packed contraction (module docstring).

    Returns (C, MultiplyInfo); C is at COARSE granularity (block_size =
    plan.tile) with exactly the tiles some FINE pair touches: the fine
    product's support rounded up to tiles.  `n_block_pairs` and
    `n_leaf_multiplies` report the honest fine-leaf GEMM count.

    `layout` names one of the reference's three panel-assembly
    formulations ("plain", "t", "mc"), a TPU layout choice with the same
    math and result.  The port accepts and checks it and runs one
    formulation for all three: gather [Tg, Lk, tile, bf] A columns and
    [Tg, Lk, bf, tile] B rows, one `bmm` of [Tg, tile, Lk*bf] by
    [Tg, Lk*bf, tile].
    """
    if layout not in ("plain", "t", "mc"):
        # A typo must not silently measure the default variant.
        raise ValueError(f"layout must be one of 'plain'/'t'/'mc', got {layout!r}")
    bf, f, tile = plan.block_size, plan.leaves, plan.tile
    dev = a.device
    mism = ids_mismatch(((a.ids, plan.a_ids), (b.ids, plan.b_ids)))
    NA, NB = plan.n_a_cols, plan.n_b_rows
    acc = torch.promote_types(a.dtype, torch.float32)
    # At "default" the packed operands are stored in bf16, rounded as the
    # reference's single bf16 pass rounds them; the products and their sum
    # stay f32.  That halves the gather bytes.
    store = torch.bfloat16 if precision == "default" and a.dtype == torch.float32 else a.dtype
    # Packed operands: one [tile, bf] column per occupied A (I, k), one
    # [bf, tile] row per occupied B (k, J); absent fine leaves stay 0.
    # Valid leaves hit distinct slots; padding leaves (all-zero) all go to
    # the pad slot, which is zeroed again after the scatter.
    a_cols = torch.zeros((NA + 1, f, bf, bf), dtype=store, device=dev)
    a_cols[plan.a_scat_col.long(), plan.a_scat_off.long()] = a.data.to(store)
    a_cols[NA] = 0
    a_cols = a_cols.reshape(NA + 1, f * bf, bf)
    b_rows = torch.zeros((NB + 1, f, bf, bf), dtype=store, device=dev)
    b_rows[plan.b_scat_row.long(), plan.b_scat_off.long()] = b.data.to(store)
    b_rows[NB] = 0
    # [slot, u (col leaf), r, c] -> [slot, r, (u, c)] = [bf, tile] rows.
    b_rows = b_rows.permute(0, 2, 1, 3).reshape(NB + 1, bf, f * bf)

    out = torch.empty((plan.n_tiles, tile, tile), dtype=acc, device=dev)
    with matmul_precision(precision, dev):
        for sa, sb, slot in zip(plan.a_src, plan.b_src, plan.c_slot):
            tg, lk = sa.shape
            # [Tg, Lk, tile, bf] -> [Tg, tile, (Lk, bf)].
            pa = a_cols[sa.long()].permute(0, 2, 1, 3).reshape(tg, tile, lk * bf)
            pb = b_rows[sb.long()].reshape(tg, lk * bf, tile)
            out[slot.long()] = torch.bmm(pa.to(acc), pb.to(acc))
    out = (out * basic._scalar(alpha, out)).to(a.dtype)

    c = BlockMatrix(
        ids=plan.c_ids,
        data=out,
        nnz=torch.tensor(plan.n_tiles, dtype=torch.int32, device=dev),
        n_rows=a.n_rows,
        n_cols=b.n_cols,
        block_size=tile,
    )
    n_leaf = torch.tensor(plan.n_leaf_pairs, dtype=torch.int32, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    info = MultiplyInfo(
        n_block_pairs=n_leaf,
        n_out_blocks=torch.tensor(plan.n_tiles, dtype=torch.int32, device=dev),
        pair_overflow=false,
        out_overflow=false,
        row_overflow=false,
        plan_mismatch=mism,
        n_leaf_multiplies=n_leaf,
    )
    return c, info
