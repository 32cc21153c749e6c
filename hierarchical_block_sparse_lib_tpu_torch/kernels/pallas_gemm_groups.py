"""Row-group SpGEMM: the host planner `plan_groups`, the wrapper of the
Hopper kernel ``kernels/csrc/gemm_groups.cu`` and its plain PyTorch
version.

Replaces ``hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_groups.py``.
The B row panels that G consecutive A rows need span one contiguous range
of B's sorted blocks, the group's slab ``[b_row_start[kmin],
b_row_start[kmax+1])``, where [kmin, kmax] is the union column range of
the group's A blocks; on a banded matrix the slab holds about G +
bandwidth panels where the per-row kernel reads G * bandwidth.
`groups_spgemm` keeps the reference's contract, that of `rows_spgemm`
(exact slots per `out_ids`, a slot no product reaches is zero, a zero
tail), computed from the group tables (`group_tables`) with the
reference's clamps to the bucketed group caps, so an undersized cap gives
in-bounds wrong values that `spgemm`'s group check flags.

`plan_groups` returns the same `GroupPlan` as the JAX package for the same
ids.  Its choice of G is the reference's rule (`reference_group_rule`:
the largest preferred G whose capacities fit the TPU kernel's 13.5 MB VMEM
budget, with ``nbc <= 4096``), kept so that both packages pick the same
backend on the same input; the kernel itself keeps nothing resident and
its `supported()` has no such gate.

Tiers on the card are those of `rows_spgemm` (the ring engine of
kernels/csrc/gemm_tile.cuh): "highest" on f32 data is 3xTF32 on wgmma,
"high" the bf16x3 split and "default" one bf16 pass on mma.sync, bf16
data one exact bf16 pass.  At b = 128 the kernel splits a slot and orders
its products as the row-panel and pair-stream kernels do, so the three
backends give the same bits.

A CPU tensor takes `groups_spgemm_reference`; a CUDA tensor launches the
kernel or raises.  `groups_spgemm.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
    _PRECISIONS,
    _bucket,
    _check_index,
    build_tables,
    check_blocks,
    pair_slots,
    tier_bmm,
)
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import (
    _VMEM_BUDGET,
    CONFIG_KEYS,
    _tier,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span

_DTYPES = (torch.float32, torch.bfloat16)


def supported(b: int, dtype) -> bool:
    """Group kernel applicability on the card: b a multiple of 128, f32
    or bf16 data.  No VMEM or `nbc` gate: the kernel keeps no slab
    resident."""
    return b % 128 == 0 and dtype in _DTYPES


def _reference_tier(b: int, itemsize: int, a_grp_max: int, slab_max: int,
                    c_grp_max: int):
    """The TPU kernel's pipeline tier (acc_parities, panel_parities) whose
    buffers fit its VMEM budget, or None."""
    am, sm, cm = _bucket(a_grp_max), _bucket(slab_max), _bucket(c_grp_max)
    for acc_p, panel_p in ((2, 2), (1, 2), (1, 1)):
        vmem = panel_p * (am + sm) * b * b * itemsize + acc_p * cm * b * b * 4
        if vmem <= _VMEM_BUDGET:
            return acc_p, panel_p
    return None


def reference_group_rule(b: int, dtype, a_grp_max: int, slab_max: int,
                         c_grp_max: int, nbc: int) -> bool:
    """The JAX package's `supported()` for its group kernel, which its
    planner uses to choose G: b % 128 == 0, ``nbc <= 4096``, not float64,
    and a VMEM pipeline tier that fits the group caps.  A TPU memory rule,
    kept only so that `plan_groups` chooses as the reference does."""
    return (
        b % 128 == 0
        and nbc <= 4096
        and dtype != torch.float64
        and _reference_tier(b, dtype.itemsize, a_grp_max, slab_max, c_grp_max)
        is not None
    )


@dataclass(frozen=True)
class GroupPlan:
    """Host-planned static capacities for `groups_spgemm` (exact maxima
    over row groups; reusable while both operands keep their ids)."""

    g: int  # rows per group
    a_grp_max: int  # max A blocks in any group
    slab_max: int  # max B slab blocks of any group
    c_grp_max: int  # max C slots in any group
    slab_blocks: int  # total B blocks over all slabs
    pairs: int  # block pairs (the per-row kernel's B reads, in blocks)

    @property
    def caps(self):
        return (self.g, self.a_grp_max, self.slab_max, self.c_grp_max)

    @property
    def reuse(self) -> float:
        """B reads of the per-row panel kernel over those of the slabs."""
        return self.pairs / max(self.slab_blocks, 1)


def plan_groups(a, b, prefer=(16, 8, 4, 2, 1)) -> GroupPlan | None:
    """The largest G in `prefer` that the reference's rule accepts, with
    the exact per-group maxima, or None (a non-local structure, whose
    slabs approach all of B).  Host numpy on the id structure only."""
    with span("hbsm.host_plan"):
        a_ids = a.ids.cpu().numpy().astype(np.int64)
        b_ids = b.ids.cpu().numpy().astype(np.int64)
        a_ids = a_ids[a_ids != SENTINEL]
        b_ids = b_ids[b_ids != SENTINEL]
        nbr, a_nbc = a.nb_rows, a.nb_cols
        nbrB, nbc = b.nb_rows, b.nb_cols
        if b.block_size % 128 != 0 or nbc > 4096 or a_ids.size == 0:
            return None
        a_row, a_col = a_ids // a_nbc, a_ids % a_nbc
        b_row = b_ids // nbc
        b_row_start = np.searchsorted(b_row, np.arange(nbrB + 1))
        # Exact product support per C row, from the panel widths.
        panel_cnt = b_row_start[a_col + 1] - b_row_start[a_col]
        pairs = int(panel_cnt.sum())
        offs = np.concatenate([[0], np.cumsum(panel_cnt)])
        b_col = b_ids % nbc
        lo = b_row_start[a_col]
        chunk = 1 << 22
        c_ids = []
        for s in range(0, pairs, chunk):
            p = np.arange(s, min(s + chunk, pairs))
            e = np.searchsorted(offs, p, side="right") - 1
            c_ids.append(np.unique(a_row[e] * nbc + b_col[lo[e] + (p - offs[e])]))
        u = np.unique(np.concatenate(c_ids)) if c_ids else np.zeros(0, np.int64)
        c_row_cnt = np.bincount(u // nbc, minlength=nbr)
        for g in prefer:
            ngrp = -(-nbr // g)
            gid = a_row // g
            a_grp = np.bincount(gid, minlength=ngrp)
            kmin = np.full(ngrp, nbrB, np.int64)
            kmax = np.full(ngrp, -1, np.int64)
            np.minimum.at(kmin, gid, a_col)
            np.maximum.at(kmax, gid, a_col)
            slab = np.where(
                kmax >= 0,
                b_row_start[np.minimum(kmax + 1, nbrB)] - b_row_start[np.minimum(kmin, nbrB)],
                0,
            )
            c_grp = np.add.reduceat(
                np.concatenate([c_row_cnt, np.zeros(ngrp * g - nbr, np.int64)]),
                np.arange(0, ngrp * g, g),
            )
            caps = (int(a_grp.max()), int(slab.max()), int(c_grp.max()))
            if reference_group_rule(b.block_size, a.dtype, *caps, nbc):
                return GroupPlan(g, *caps, slab_blocks=int(slab.sum()), pairs=pairs)
        return None


@dataclass(frozen=True)
class GroupTables:
    """Device tables of one (A, B, out_ids) structure at G rows per group:
    the row tables of `build_tables`, and per group its first A entry and C
    slot (``[ngrp + 1]``) and its B slab (first block, block count)."""

    a_row_start: torch.Tensor
    a_col: torch.Tensor
    b_row_start: torch.Tensor
    b_col: torch.Tensor
    grp_a_start: torch.Tensor
    grp_c_start: torch.Tensor
    slab_lo: torch.Tensor
    slab_cnt: torch.Tensor


def group_tables(a_ids, b_ids, out_ids, nbr: int, nbrB: int, nbc: int,
                 g_rows: int) -> GroupTables:
    """The group tables, built on the ids' device without a host read.
    A's row and column are ``a_id // nbrB`` and ``a_id % nbrB``: A's
    block-column count is B's block-row count."""
    a_row_start, a_col, b_row_start, b_col, c_row_start, _ = build_tables(
        a_ids, b_ids, out_ids, nbr, nbrB, nbc
    )
    dev = a_ids.device
    ngrp = -(-nbr // g_rows)
    grp_rows = torch.clamp(torch.arange(ngrp + 1, device=dev) * g_rows, max=nbr)
    valid = a_ids != SENTINEL
    gid = torch.clamp(torch.where(valid, a_ids // nbrB, nbr) // g_rows, max=ngrp - 1).long()
    kmin = torch.full((ngrp,), nbrB, dtype=torch.int32, device=dev).scatter_reduce(
        0, gid, torch.where(valid, a_col, nbrB), "amin"
    )
    kmax = torch.full((ngrp,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, gid, torch.where(valid, a_col, -1), "amax"
    )
    nonempty = kmax >= 0
    slab_lo = torch.where(nonempty, b_row_start[kmin.clamp(0, nbrB).long()], 0)
    slab_cnt = torch.where(
        nonempty, b_row_start[(kmax + 1).clamp(0, nbrB).long()] - slab_lo, 0
    )
    return GroupTables(
        a_row_start, a_col, b_row_start, b_col,
        a_row_start[grp_rows], c_row_start[grp_rows],
        slab_lo.to(torch.int32), slab_cnt.to(torch.int32),
    )


def _group_pairs(t: GroupTables, a_ids, nbrB: int, g_rows: int,
                 a_grp_max: int, slab_max: int, cap_b: int):
    """The pairs the kernel's clamps give: (A block, B block, B column,
    A row) per pair, int64.  Sizing the list reads the device."""
    dev = a_ids.device
    valid = a_ids != SENTINEL
    e = torch.arange(a_ids.shape[0], device=dev)
    row = torch.where(valid, a_ids // nbrB, 0).long()
    g = row // g_rows
    a_lo = t.grp_a_start[g].long()
    ea = a_lo + torch.clamp(e - a_lo, 0, a_grp_max - 1)
    k = t.a_col.long()
    blo = t.b_row_start[k].long()
    s_lo = t.slab_lo[g].long()
    poff = torch.clamp(blo - s_lo, 0, slab_max - 1)
    cnt = torch.minimum(t.b_row_start[k + 1].long() - blo, slab_max - poff)
    cnt = torch.where(valid, cnt, 0)
    pe = torch.repeat_interleave(e, cnt)
    off = torch.arange(pe.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[pe]
    b_blk = torch.clamp(s_lo[pe] + poff[pe] + off, max=cap_b - 1)
    return ea[pe], b_blk, t.b_col[blo[pe] + off].long(), row[pe]


def groups_spgemm_reference(
    a_ids, a_data, b_ids, b_data, out_ids, nbr: int, nbrB: int, nbc: int,
    out_cap: int, g_rows: int, a_grp_max: int, slab_max: int, c_grp_max: int,
    precision: str = "highest", tables: GroupTables | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of `groups_spgemm` (same arguments), on
    any device: expand the pairs the group tables and clamps give, one
    batched `torch.bmm` at the tier, an `index_add_` into ``out_cap + 1``
    slots whose last (pairs with no slot) is dropped."""
    del c_grp_max
    b = a_data.shape[-1]
    dev = a_data.device
    precision = _tier(precision, a_data.dtype)
    if tables is None:
        tables = group_tables(a_ids, b_ids, out_ids, nbr, nbrB, nbc, g_rows)
    out = torch.zeros((out_cap + 1, b, b), dtype=torch.float32, device=dev)
    if out_cap == 0 or b_data.shape[0] == 0:
        return out[:out_cap]
    a_blk, b_blk, col, row = _group_pairs(
        tables, a_ids, nbrB, g_rows, _bucket(a_grp_max), _bucket(slab_max),
        b_data.shape[0],
    )
    slot = pair_slots(out_ids, (row * nbc + col).to(torch.int32), out_cap)
    prod = tier_bmm(a_data[a_blk].to(torch.float32), b_data[b_blk].to(torch.float32), precision)
    out.index_add_(0, slot, prod)
    return out[:out_cap]


_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entries of gemm_groups.cu and their arguments (pointers and the
# stream as c_void_p, ints as c_int).
SIGNATURES = {
    "hbsm_groups_spgemm": [_P] * 10 + [_I] * 10 + [_P],
    "hbsm_groups_spgemm_config": [_I, _I, _P],
}


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

        lib = _build.load("gemm_groups")
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _I, args
        lib.hbsm_cuda_error_string.restype = ctypes.c_char_p
        lib.hbsm_cuda_error_string.argtypes = [_I]
        _LIB = lib
    return _LIB


def launch_config(dtype, precision: str) -> dict:
    """What a launch for this data type and tier gets, read from the
    library and the card: dynamic shared bytes, resident blocks per SM,
    registers and local (spill) bytes per thread, threads per block."""
    lib = _kernel_lib()
    info = (ctypes.c_int * len(CONFIG_KEYS))()
    err = lib.hbsm_groups_spgemm_config(
        int(dtype == torch.bfloat16), _PRECISIONS[_tier(precision, dtype)],
        ctypes.cast(info, ctypes.c_void_p),
    )
    if err != 0:
        raise RuntimeError(
            f"groups_spgemm config: {lib.hbsm_cuda_error_string(err).decode()}"
        )
    return dict(zip(CONFIG_KEYS, info))


def groups_spgemm(
    a_ids: torch.Tensor,  # int32[capA] sorted (SENTINEL padded)
    a_data: torch.Tensor,  # [capA, b, b] f32 or bf16
    b_ids: torch.Tensor,  # int32[capB] sorted
    b_data: torch.Tensor,  # [capB, b, b], A's type
    out_ids: torch.Tensor,  # int32[out_cap] sorted distinct output ids
    nbr: int,  # A block-rows
    nbrB: int,  # B block-rows (= A block-cols)
    nbc: int,  # B block-cols
    out_cap: int,
    g_rows: int,
    a_grp_max: int,
    slab_max: int,
    c_grp_max: int,
    precision: str = "highest",
    tables: GroupTables | None = None,  # group_tables(...) of these ids
) -> torch.Tensor:
    """f32[out_cap, b, b]: block products accumulated into the slots of
    `out_ids`, B read through each group's slab.  "high" is the bf16x3
    split for f32 data and one exact pass for bf16 data."""
    device = a_data.device
    args = (a_ids, a_data, b_ids, b_data, out_ids, nbr, nbrB, nbc, out_cap,
            g_rows, a_grp_max, slab_max, c_grp_max)
    if device.type == "cpu":
        return groups_spgemm_reference(*args, precision=precision, tables=tables)
    if device.type != "cuda":
        raise ValueError(f"groups_spgemm runs on CPU or CUDA tensors, got {device}")
    b = a_data.shape[-1]
    if not supported(b, a_data.dtype):
        raise ValueError(
            f"the group kernel needs b % 128 == 0 with f32 or bf16 data, "
            f"got b={b} {a_data.dtype}"
        )
    if g_rows < 1:
        raise ValueError(f"g_rows must be >= 1, got {g_rows}")
    precision = _tier(precision, a_data.dtype)
    a_data, b_data = a_data.contiguous(), b_data.contiguous()
    cap_a, cap_b = a_data.shape[0], b_data.shape[0]
    check_blocks("a_data", a_data, (cap_a, b, b), a_data.dtype, device)
    check_blocks("b_data", b_data, (cap_b, b, b), a_data.dtype, device)
    if min(cap_a, cap_b) == 0:
        raise ValueError("the group kernel needs operands with capacity >= 1")
    if tables is None:
        tables = group_tables(a_ids, b_ids, out_ids, nbr, nbrB, nbc, g_rows)
    ngrp = -(-nbr // g_rows)
    for name, t, n in (
        ("out_ids", out_ids, out_cap), ("a_row_start", tables.a_row_start, nbr + 1),
        ("a_col", tables.a_col, cap_a), ("b_row_start", tables.b_row_start, nbrB + 1),
        ("b_col", tables.b_col, cap_b), ("grp_a_start", tables.grp_a_start, ngrp + 1),
        ("slab_lo", tables.slab_lo, ngrp),
    ):
        _check_index(name, t, n, device)
    out = torch.empty((out_cap, b, b), dtype=torch.float32, device=device)
    if out_cap == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.hbsm_groups_spgemm(
            out_ids.data_ptr(), tables.a_row_start.data_ptr(), tables.a_col.data_ptr(),
            tables.b_row_start.data_ptr(), tables.b_col.data_ptr(),
            tables.grp_a_start.data_ptr(), tables.slab_lo.data_ptr(),
            a_data.data_ptr(), b_data.data_ptr(), out.data_ptr(),
            out_cap, nbr, nbc, g_rows, _bucket(a_grp_max), _bucket(slab_max),
            cap_b, b, int(a_data.dtype == torch.bfloat16),
            _PRECISIONS[precision], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"groups_spgemm launch failed: {lib.hbsm_cuda_error_string(err).decode()}"
        )
    groups_spgemm.launches += 1
    return out


groups_spgemm.launches = 0
