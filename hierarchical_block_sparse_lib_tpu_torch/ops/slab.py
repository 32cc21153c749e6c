"""Column-slab SpGEMM (port of ``ops/slab.py``): the near-dense,
huge-order tier that B4 at its configured size runs (32768², 50% block
density, BASELINE.json:10).

B is split into `n_slabs` contiguous block-column slabs; each slab's
product C_s = A @ B_s runs as one exactly planned `spgemm` on the
row-panel kernel (`row_caps` per slab), and its output blocks, disjoint
from every other slab's, are copied straight into host-planned positions
of the final sorted output.  There is no concatenate-and-sort merge, so
the peak stays about A + C + one slab.  B traffic is unchanged (each
pair's B block is read in exactly one slab); A is read once per slab.

The plan is host numpy, field for field the JAX package's.  The device
part is one block gather per slab, its `spgemm` and one `index_copy_`,
all under the span ``hbsm.colslab``; `spgemm_colslab.slabs` counts the
slab products run.  A call makes no host sync: the plan's arrays go to
the device by non-blocking copies (a blocking copy from pageable memory
waits for the stream, so the device would idle between slabs while the
host enqueues the next), its counts by device fills.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import MultiplyInfo, spgemm
from hierarchical_block_sparse_lib_tpu_torch.runtime import native
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class SlabSpec:
    j0: int
    j1: int
    cap: int  # B blocks in the slab
    pair_cap: int
    out_cap: int
    row_caps: tuple  # (max_b_row, max_c_row) within the slab
    pos: np.ndarray  # int32[out_cap]: slots in the final output array
    # Host-planned slab extraction: storage positions of the slab's B
    # blocks and their slab-local ids.
    gather_idx: np.ndarray  # int32[cap]
    local_ids: np.ndarray  # int32[cap]


@dataclass(frozen=True)
class ColslabPlan:
    slabs: tuple  # tuple[SlabSpec]
    out_ids: np.ndarray  # int32[n_out] global ids, sorted
    total_pairs: int

    @property
    def n_out(self) -> int:
        return int(self.out_ids.size)


def plan_colslab(a: BlockMatrix, b: BlockMatrix, n_slabs: int) -> ColslabPlan:
    """Exact host plan: per-slab capacities and final merge positions.
    Reusable across value changes at fixed structure (`spgemm_colslab`'s
    ``plan=``)."""
    a_ids = a.ids.cpu().numpy()
    b_ids = b.ids.cpu().numpy()
    sent = int(SENTINEL)
    a_ids_v = a_ids[a_ids != sent]
    nbc = b.nb_cols
    bcol_full = np.where(b_ids != sent, b_ids % nbc, -1)
    bounds = np.linspace(0, nbc, n_slabs + 1).astype(int)
    slabs = []
    slab_gids = []
    total_pairs = 0
    for s in range(n_slabs):
        j0, j1 = int(bounds[s]), int(bounds[s + 1])
        if j1 <= j0:
            continue
        sel = (bcol_full >= j0) & (bcol_full < j1)
        cap_s = int(sel.sum())
        if cap_s == 0:
            continue
        nbc_s = j1 - j0
        gidx = np.nonzero(sel)[0].astype(np.int32)
        sub = b_ids[gidx].astype(np.int64)
        sub_local = ((sub // nbc) * nbc_s + (sub % nbc - j0)).astype(np.int32)
        ordr = np.argsort(sub_local, kind="stable")
        gidx = gidx[ordr]
        sub_local = sub_local[ordr]
        pc, oc, mbr, mcr = native.plan_spgemm_ex(
            a_ids, sub_local, a.nb_cols, b.nb_rows, nbc_s
        )
        if pc == 0:
            continue
        # Exact slab output ids from the host symbolic engine.
        if native.have_native():
            _, _, c_id, tot = native.symbolic_spgemm(
                a_ids, sub_local, a.nb_cols, nbc_s, pc
            )
            assert tot == pc
            loc = np.unique(c_id[c_id != sent])
        else:
            loc = _out_ids_numpy(a_ids_v, sub_local, a.nb_cols, nbc_s)
        gids = ((loc // nbc_s) * nbc + (loc % nbc_s + j0)).astype(np.int64)
        slab_gids.append(gids)
        total_pairs += pc
        slabs.append((j0, j1, cap_s, pc, oc, (mbr, mcr), gids, gidx, sub_local))
    if not slabs:
        return ColslabPlan(slabs=(), out_ids=np.empty(0, np.int32), total_pairs=0)
    out_ids = np.sort(np.concatenate(slab_gids))
    specs = []
    for j0, j1, cap_s, pc, oc, rc, gids, gidx, sloc in slabs:
        pos = np.searchsorted(out_ids, gids).astype(np.int32)
        assert pos.size == oc
        specs.append(SlabSpec(j0, j1, cap_s, pc, oc, rc, pos, gidx, sloc))
    return ColslabPlan(
        slabs=tuple(specs),
        out_ids=out_ids.astype(np.int32),
        total_pairs=int(total_pairs),
    )


def _out_ids_numpy(a_ids_v, b_local_sorted, a_nbc, nbc_s):
    """Sorted distinct output ids of A @ B_s (the fallback without the
    native library)."""
    a_row, a_col = a_ids_v // a_nbc, a_ids_v % a_nbc
    b_row, b_col = b_local_sorted // nbc_s, b_local_sorted % nbc_s
    lo = np.searchsorted(b_row, a_col, "left")
    hi = np.searchsorted(b_row, a_col, "right")
    cnt = hi - lo
    offs = np.concatenate([[0], np.cumsum(cnt)])
    n = int(cnt.sum())
    out = set()
    CHUNK = 1 << 22
    for s in range(0, n, CHUNK):
        p = np.arange(s, min(s + CHUNK, n))
        e = np.searchsorted(offs, p, "right") - 1
        t = p - offs[e]
        out.update(np.unique(a_row[e] * nbc_s + b_col[lo[e] + t]).tolist())
    return np.sort(np.fromiter(out, np.int64)) if out else np.empty(0, np.int64)


def _colslab(b: BlockMatrix, sl: SlabSpec) -> BlockMatrix:
    """The slab as a BlockMatrix: host-planned ids, and one gather of its
    blocks on B's device (no host sync)."""
    dev = b.device
    return BlockMatrix(
        ids=torch.from_numpy(sl.local_ids).to(dev, non_blocking=True),
        data=b.data[torch.from_numpy(sl.gather_idx).to(dev, non_blocking=True).long()],
        nnz=torch.full((), sl.cap, dtype=torch.int32, device=dev),
        n_rows=b.n_rows,
        n_cols=(sl.j1 - sl.j0) * b.block_size,
        block_size=b.block_size,
    )


def spgemm_colslab(
    a: BlockMatrix,
    b: BlockMatrix,
    n_slabs: int | None = None,
    plan: ColslabPlan | None = None,
    alpha=1.0,
    precision: str = "highest",
    backend: str = "auto",
):
    """C = alpha * A @ B via column slabs of B.  Returns (C, MultiplyInfo)
    with counters summed over slabs: the pair count equals the unsliced
    multiply's exactly.  Pass `plan` (from `plan_colslab`) instead of
    `n_slabs` to reuse it across fixed-structure iterations."""
    with span("hbsm.colslab"):
        if a.n_cols != b.n_rows or a.block_size != b.block_size:
            raise ValueError("dimension/block mismatch")
        if plan is None:
            if n_slabs is None:
                raise ValueError("need n_slabs or plan")
            plan = plan_colslab(a, b, n_slabs)
        bs = a.block_size
        dev = a.device
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        if plan.n_out == 0:
            from hierarchical_block_sparse_lib_tpu_torch.core import assembly

            c = assembly.empty(a.n_rows, b.n_cols, bs, 1, a.dtype, device=dev)
            return c, MultiplyInfo(
                n_block_pairs=zero_i,
                n_out_blocks=zero_i,
                pair_overflow=false,
                out_overflow=false,
                row_overflow=false,
                plan_mismatch=false,
                n_leaf_multiplies=torch.full((), -1, dtype=torch.int32, device=dev),
            )
        # The slabs' positions partition [0, n_out): every slot is written.
        out = torch.empty((plan.n_out, bs, bs), dtype=a.dtype, device=dev)
        total_pairs = zero_i
        ovf = false
        row_ovf = false
        for sl in plan.slabs:
            c_s, info = spgemm(
                a,
                _colslab(b, sl),
                pair_cap=sl.pair_cap,
                out_cap=sl.out_cap,
                alpha=alpha,
                precision=precision,
                backend=backend,
                row_caps=sl.row_caps,
            )
            pos = torch.from_numpy(sl.pos).to(dev, non_blocking=True).long()
            out.index_copy_(0, pos, c_s.data)
            spgemm_colslab.slabs += 1
            total_pairs = total_pairs + info.n_block_pairs
            ovf = ovf | info.pair_overflow | info.out_overflow
            row_ovf = row_ovf | info.row_overflow
        c = BlockMatrix(
            ids=torch.from_numpy(plan.out_ids).to(dev, non_blocking=True),
            data=out,
            nnz=torch.full((), plan.n_out, dtype=torch.int32, device=dev),
            n_rows=a.n_rows,
            n_cols=b.n_cols,
            block_size=bs,
        )
        info = MultiplyInfo(
            n_block_pairs=total_pairs,
            n_out_blocks=torch.full((), plan.n_out, dtype=torch.int32, device=dev),
            pair_overflow=ovf,
            out_overflow=ovf,
            row_overflow=row_ovf,
            plan_mismatch=false,
            n_leaf_multiplies=torch.full((), -1, dtype=torch.int32, device=dev),
        )
        return c, info


spgemm_colslab.slabs = 0
