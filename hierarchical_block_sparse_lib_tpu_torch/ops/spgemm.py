"""Hierarchical block-sparse multiply (port of ``ops/spgemm.py``): the
symbolic phase, reusable plans, the numeric backends, counters and host
planners.

The symbolic phase replaces the reference's quadtree recursion: for each
stored A block (i,k), find B's row-k run, and enumerate every
(a_idx, b_idx) pair with a prefix sum plus a searchsorted expansion.
Only stored-by-stored pairs are enumerated, so ``n_block_pairs`` is the
reference's block-multiply counter, and with leaf-occupancy masks
(``a_leaf_occ``/``b_leaf_occ``) ``n_leaf_multiplies`` counts the
products at the fine leaf size.  The numeric phase runs on the row-group
kernel (``"groups"``), the row-panel kernel (``"rows"``), the fine kernel
(``"fine"``, leaves 16/32/64), the pair-stream kernel (``"pallas"``) or
gather + `bmm` + `index_add_` (``"xla"``, the reference's non-Pallas
path, which float64 takes).

The row-panel kernel takes every leaf a multiple of 128 wide, as the
reference's does.  The upper-triangle enumeration (``syrk_upper``) runs on
"rows" (the kernel's `triu` skip), "pallas" and "xla"; `plan_syrk` sizes it and
``make_plan(sym_mirror=True)`` plans the symmetric purification step.
The norm filter (``filter_by_norm``: SpAMM, `spamm`, sized by
`plan_spamm`) runs on "rows" (the kernel's skip, fed the same norms and
tau^2 as the symbolic phase), "pallas" and "xla"; the aligned accumulate
(``accum_aligned``) on "rows", whose kernel starts each slot from the
accumulator's block.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    first_of_run,
)
from hierarchical_block_sparse_lib_tpu_torch.kernels import (
    fine_epilogue,
    pallas_gemm_fine,
    pallas_gemm_groups,
    pallas_gemm_rows,
    pallas_gemm_stream,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import (
    block_frob_squared,
    squared_threshold,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class MultiplyInfo:
    """Exact operation counters (0-dim tensors, so reading them is the
    caller's choice of when to wait for the device)."""

    n_block_pairs: torch.Tensor  # int32[] — leaf GEMMs performed
    n_out_blocks: torch.Tensor  # int32[] — distinct output blocks
    pair_overflow: torch.Tensor  # bool[] — pair_cap too small
    out_overflow: torch.Tensor  # bool[] — out_cap too small
    row_overflow: torch.Tensor  # bool[] — row caps too small
    # True when a `plan=` was supplied but an operand's id structure
    # differs from the one the plan was built for (the result is wrong).
    plan_mismatch: torch.Tensor
    n_leaf_multiplies: torch.Tensor  # int32[]


def spgemm_symbolic(
    a: BlockMatrix,
    b: BlockMatrix,
    pair_cap: int,
    tau=0.0,
    filter_by_norm: bool = False,
    syrk_upper: bool = False,
):
    """Enumerate contributing block pairs, sorted by output block id.

    Returns (a_idx, b_idx, c_id, total, raw_total): int32[pair_cap]
    arrays; entries past `total` have c_id == SENTINEL.  `total` counts
    the pairs that survive the filters, `raw_total` all enumerated pairs
    (enumeration overflows iff raw_total > pair_cap).

    Filters drop pairs before the numeric phase; survivors sort to the
    front, so a caller may slice the lists to a tight `gemm_cap`.
    `filter_by_norm` drops the pairs whose a-priori product bound
    ``||A_ik||_F * ||B_kj||_F <= tau`` (SpAMM; compared squared, in f32,
    as ``an2 * bn2 > f32(tau)^2``).  `syrk_upper` keeps the pairs of
    upper-triangle outputs (block row <= block column): for C = A @ A^T
    (b = A^T) the caller mirrors C_ji = C_ij^T afterwards, about half the
    leaf products.
    """
    norm_filter = spamm_filter(a, b, tau) if filter_by_norm else None
    return _symbolic(a, b, pair_cap, norm_filter, syrk_upper)


def spamm_filter(a: BlockMatrix, b: BlockMatrix, tau):
    """(an2, bn2, tau2) of the norm filter: the per-block squared norms of
    each operand (one norm pass each; one for both when b is a) and tau^2
    in f32.  One triple feeds both the symbolic phase and the row-panel
    kernel's skip, so the two make the same decisions."""
    an2 = block_frob_squared(a)
    bn2 = an2 if b is a else block_frob_squared(b)
    return an2, bn2, squared_threshold(tau)


def _keep_by_norm(norm_filter, a_idx, b_idx) -> torch.Tensor:
    an2, bn2, tau2 = norm_filter
    return an2[a_idx] * bn2[b_idx] > tau2


def _symbolic(a: BlockMatrix, b: BlockMatrix, pair_cap: int, norm_filter, syrk_upper: bool):
    """`spgemm_symbolic` with the norm filter given as `spamm_filter`'s
    triple (or None)."""
    with span("hbsm.symbolic"):
        dev = a.ids.device
        i32 = torch.int32
        a_valid = a.valid_mask()
        a_row = a.ids // a.nb_cols
        a_col = torch.where(a_valid, a.ids % a.nb_cols, a.nb_cols).to(i32)
        b_row = torch.where(b.valid_mask(), b.ids // b.nb_cols, b.nb_rows + 1).to(i32)
        b_col = b.ids % b.nb_cols

        # Row-k range of B for each A block's column k; padding rows carry
        # the miss key nb_rows, so lo == hi == end-of-valid.
        b_row_start = torch.searchsorted(
            b_row, torch.arange(b.nb_rows + 1, dtype=i32, device=dev),
            right=False, out_int32=True,
        )
        lo = b_row_start[torch.clamp(a_col, max=b.nb_rows).long()]
        hi = b_row_start[torch.clamp(a_col + 1, max=b.nb_rows).long()]
        cnt = torch.where(a_valid, hi - lo, 0)
        offs = torch.cumsum(cnt, 0, dtype=i32)
        raw_total = offs[-1]

        # Expand: pair p belongs to A entry e = first index with offs[e] > p.
        p = torch.arange(pair_cap, dtype=i32, device=dev)
        e = torch.searchsorted(offs, p, right=True, out_int32=True)
        e_c = torch.clamp(e, max=a.cap - 1).long()
        base = torch.where(e_c > 0, offs[e_c - 1], 0)
        t = p - base
        valid_p = p < raw_total
        a_idx = e_c
        b_idx = torch.clamp(lo[e_c] + t, max=b.cap - 1).long()
        c_row, c_col = a_row[e_c], b_col[b_idx]
        # Each filter masks valid_p; `total` then counts the survivors.
        if norm_filter is not None:
            valid_p = valid_p & _keep_by_norm(norm_filter, a_idx, b_idx)
        if syrk_upper:
            valid_p = valid_p & (c_row <= c_col)
        c_id = torch.where(valid_p, c_row * b.nb_cols + c_col, SENTINEL).to(i32)
        filtered = norm_filter is not None or syrk_upper
        total = valid_p.sum().to(i32) if filtered else raw_total
        order = torch.argsort(c_id, stable=True)
        return (
            a_idx[order].to(i32),
            b_idx[order].to(i32),
            c_id[order],
            total.to(i32),
            raw_total.to(i32),
        )


def plan_spgemm_ex(a: BlockMatrix, b: BlockMatrix):
    """Host-side exact plan: (n_pairs, n_out_blocks, max_b_row, max_c_row).
    The row maxima are `fine_matmul`'s `row_caps`."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    with span("hbsm.host_plan"):
        return native.plan_spgemm_ex(
            a.ids.cpu().numpy(), b.ids.cpu().numpy(), a.nb_cols, b.nb_rows, b.nb_cols
        )


def plan_spgemm(a: BlockMatrix, b: BlockMatrix):
    """Host-side exact symbolic plan: (n_pairs, n_out_blocks), to size
    pair_cap / out_cap."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    with span("hbsm.host_plan"):
        return native.plan_spgemm(
            np.asarray(a.ids.cpu()), np.asarray(b.ids.cpu()),
            a.nb_cols, b.nb_rows, b.nb_cols,
        )


class SyrkPlan:
    """Exact host plan of the symmetric product C = A @ A^T with
    upper-triangle-only (i <= j) enumeration."""

    __slots__ = (
        "pairs_raw", "pairs_upper", "out_upper", "out_diag",
        "max_b_row", "max_c_row",
    )

    def __init__(self, pairs_raw, pairs_upper, out_upper, out_diag,
                 max_b_row, max_c_row):
        self.pairs_raw = pairs_raw  # unfiltered enumeration size
        self.pairs_upper = pairs_upper  # leaf products actually done
        self.out_upper = out_upper  # distinct i <= j output blocks
        self.out_diag = out_diag  # of which diagonal (i == j)
        self.max_b_row = max_b_row  # row-panel kernel caps
        self.max_c_row = max_c_row

    @property
    def out_full(self):
        """Distinct output blocks after mirroring."""
        return 2 * self.out_upper - self.out_diag


def plan_syrk(a: BlockMatrix) -> SyrkPlan:
    """Host-side exact plan for `syrk` (C = A @ A^T, upper-only pairs):
    the symbolic workspace enumerates all `pairs_raw` candidates
    (pair_cap), and `pairs_upper` of them, about half, reach the numeric
    phase (gemm_cap)."""
    with span("hbsm.host_plan"):
        ids = a.ids.cpu().numpy().astype(np.int64)
        ids = ids[ids != SENTINEL]
        nbc, nbr = a.nb_cols, a.nb_rows
        row, col = ids // nbc, ids % nbc
        # A^T in canonical sorted order; its block-rows are A's block-cols.
        at = np.sort(col * nbr + row)
        at_row, at_col = at // nbr, at % nbr
        lo = np.searchsorted(at_row, col, side="left")
        hi = np.searchsorted(at_row, col, side="right")
        cnt = hi - lo
        pairs_raw = int(cnt.sum())
        offs = np.concatenate([[0], np.cumsum(cnt)])
        max_b_row = int(np.bincount(col).max()) if ids.size else 0
        pairs_upper = 0
        out_ids: set = set()
        chunk = 1 << 22
        for s in range(0, pairs_raw, chunk):
            p = np.arange(s, min(s + chunk, pairs_raw))
            e = np.searchsorted(offs, p, side="right") - 1
            j = lo[e] + p - offs[e]
            keep = row[e] <= at_col[j]
            pairs_upper += int(keep.sum())
            out_ids.update(np.unique((row[e] * nbr + at_col[j])[keep]).tolist())
        if out_ids:
            oid = np.fromiter(out_ids, np.int64)
            out_diag = int(np.sum(oid // nbr == oid % nbr))
            max_c_row = int(np.bincount(oid // nbr).max())
        else:
            out_diag = max_c_row = 0
        return SyrkPlan(pairs_raw, pairs_upper, len(out_ids), out_diag, max_b_row, max_c_row)


@dataclass(frozen=True)
class SymbolicPlan:
    """Device-resident symbolic plan (the output of `spgemm_symbolic`),
    reusable across `spgemm` calls while both operands keep exactly the
    same id structure: only the numeric phase runs.  Build with
    `make_plan`.

    Built with ``accum_ids=``/``out_cap=``, it also holds the union
    structure of the product support with the accumulator support
    (`out_ids`, `seg`, `pos_acc`, `n_unique`), so a fixed-support
    C = alpha*A@B + beta*D costs no structural work at all.

    Built with ``sym_mirror=True`` for a symmetric product structure, it
    also holds the mirror map: `mirror_src[j]` is the union slot holding
    the transpose of slot j's block (slot j itself for upper and diagonal
    slots), `total_syrk` the upper-triangle pairs (the products of the
    `syrk_upper` run), and `mirror_ok` is False when the union id set is
    not symmetric (folded into `plan_mismatch`)."""

    a_idx: torch.Tensor  # int32[pair_cap]
    b_idx: torch.Tensor  # int32[pair_cap]
    c_id: torch.Tensor  # int32[pair_cap], sorted, SENTINEL padded
    total: torch.Tensor  # int32[] surviving pairs
    raw_total: torch.Tensor  # int32[] unfiltered enumeration size
    # Operand id structure the plan was built for, compared on use
    # (MultiplyInfo.plan_mismatch).
    a_ids: torch.Tensor | None = None  # int32[capA]
    b_ids: torch.Tensor | None = None  # int32[capB]
    out_ids: torch.Tensor | None = None  # int32[out_cap] union ids
    seg: torch.Tensor | None = None  # int32[pair_cap] pair -> union slot
    pos_acc: torch.Tensor | None = None  # int32[acc_cap] accum -> union slot
    n_unique: torch.Tensor | None = None  # int32[] distinct union blocks
    acc_ids: torch.Tensor | None = None  # int32[acc_cap] planned accum ids
    mirror_src: torch.Tensor | None = None  # int32[out_cap]
    total_syrk: torch.Tensor | None = None  # int32[]
    mirror_ok: torch.Tensor | None = None  # bool[]


def ids_mismatch(pairs) -> torch.Tensor:
    """True when any (operand ids, ids a plan was built for) pair differs,
    in shape or in value: a stale plan's `plan_mismatch` (0-dim bool on
    the operands' device, no host sync)."""
    mism = torch.zeros((), dtype=torch.bool, device=pairs[0][0].device)
    for got, want in pairs:
        if got.shape != want.shape:
            mism = torch.ones_like(mism)
        else:
            mism = mism | torch.any(got != want)
    return mism


def _norm_drift(plan: SymbolicPlan, norm_filter, a: BlockMatrix, b: BlockMatrix,
                syrk_upper: bool) -> torch.Tensor:
    """True when the operands' current norms keep another set of pairs
    than the plan's (0-dim bool).  The symbolic phase's stable sort puts
    the survivors first, then the dropped enumerated pairs, then the
    padding, so the first `raw_total` plan entries are the enumeration."""
    a_idx = plan.a_idx.long().clamp(max=a.cap - 1)  # a stale plan's may not fit
    b_idx = plan.b_idx.long().clamp(max=b.cap - 1)
    keep = _keep_by_norm(norm_filter, a_idx, b_idx)
    if syrk_upper:
        keep = keep & (a.ids[a_idx] // a.nb_cols <= b.ids[b_idx] % b.nb_cols)
    enumerated = torch.arange(a_idx.shape[0], device=a_idx.device) < plan.raw_total
    return torch.any(enumerated & (keep != (plan.c_id != SENTINEL)))


def _mirror_map(c_id: torch.Tensor, out_ids: torch.Tensor, nb: int) -> dict:
    """The symmetric-mirror fields of a plan over product ids `c_id` and
    union ids `out_ids` on an nb x nb block grid (`SymbolicPlan`)."""
    cv = c_id != SENTINEL
    total_syrk = (cv & (c_id // nb <= c_id % nb)).sum().to(torch.int32)
    ov = out_ids != SENTINEL
    orow = torch.where(ov, out_ids // nb, 0)
    ocol = torch.where(ov, out_ids % nb, 0)
    mid = torch.where(ov, ocol * nb + orow, SENTINEL).to(torch.int32)
    src = torch.searchsorted(out_ids, mid, out_int32=True).clamp_(max=out_ids.shape[0] - 1)
    lower = ov & (orow > ocol)
    own = torch.arange(out_ids.shape[0], dtype=torch.int32, device=out_ids.device)
    return dict(
        mirror_src=torch.where(lower, src, own),
        total_syrk=total_syrk,
        # A lower slot without its transpose partner: a stale plan or an
        # asymmetric structure, loud through plan_mismatch.
        mirror_ok=torch.all(torch.where(lower, out_ids[src.long()] == mid, True)),
    )


def make_plan(
    a: BlockMatrix,
    b: BlockMatrix,
    pair_cap: int,
    tau=0.0,
    filter_by_norm: bool = False,
    syrk_upper: bool = False,
    accum_ids: torch.Tensor | None = None,
    out_cap: int | None = None,
    sym_mirror: bool = False,
) -> SymbolicPlan:
    """Run the symbolic phase once for reuse via ``spgemm(..., plan=...)``;
    valid while both operands' id arrays are unchanged (data may change
    freely), self-checked on use.  With `accum_ids` (the accumulator's
    sorted ids) and `out_cap`, the beta-accumulate union is planned too:
    the matching ``spgemm(..., plan=..., accum=...)`` call uses the same
    `out_cap` and an accumulator with exactly these ids.

    With `sym_mirror=True` (needs `accum_ids`/`out_cap`; operands and
    union symmetric in structure) the plan also carries the mirror map of
    the planned symmetric step: ``spgemm(..., plan=..., syrk_upper=True)``
    fills the generic union slots with upper-triangle products only (the
    row-panel kernel's `triu` skip), then the caller overwrites the
    strictly lower slots with transposed upper blocks through
    `mirror_src` (see `models.purification.sp2_step`).  That differs from
    `syrk_upper=True` here, which plans upper-only pairs and outputs."""
    sym = spgemm_symbolic(
        a, b, pair_cap, tau=tau, filter_by_norm=filter_by_norm, syrk_upper=syrk_upper,
    )
    rec = dict(a_ids=a.ids, b_ids=b.ids)
    if accum_ids is None:
        if sym_mirror:
            raise ValueError("sym_mirror requires accum_ids/out_cap")
        return SymbolicPlan(*sym, **rec)
    if out_cap is None:
        raise ValueError("make_plan(accum_ids=...) requires out_cap")
    out_ids, seg, pos_acc, n_unique = basic.union_merge(sym[2], accum_ids, out_cap)
    mirror = {}
    if sym_mirror:
        if a.n_rows != a.n_cols:
            raise ValueError("sym_mirror needs a square matrix")
        mirror = _mirror_map(sym[2], out_ids, a.nb_rows)
    return SymbolicPlan(
        *sym, **rec, out_ids=out_ids, seg=seg, pos_acc=pos_acc,
        n_unique=n_unique, acc_ids=accum_ids, **mirror,
    )


def alpha_is_one_static(alpha) -> bool:
    return isinstance(alpha, (int, float)) and float(alpha) == 1.0


def resolve_backend(
    block_size,
    dtype,
    nbc_b: int,
    pair_cap: int,
    row_caps=None,
    group_caps=None,
    filter_by_norm: bool = False,
    syrk_upper: bool = False,
) -> str:
    """The backend ``spgemm(backend="auto")`` runs, as a host-side decision
    callers can log; spgemm itself calls this.  The same rule holds on
    the CPU and on the card (the kernel modules take their plain versions
    for CPU tensors):

    - float64 data: ``"xla"`` (the kernels accumulate in f32);
    - `group_caps` given and the row-group kernel takes the leaf (never
      with `syrk_upper`): ``"groups"``;
    - `row_caps` given and the row-panel kernel takes the leaf: ``"rows"``;
    - `row_caps` given and the fine kernel takes the leaf (never with
      `syrk_upper`): ``"fine"``;
    - other b % 128 == 0: ``"pallas"``, the pair-stream kernel;
    - anything else: ``"xla"``.

    The reference's `pair_cap >= 1024` gate and its SMEM/VMEM gates were
    measured on or set by a TPU and are not carried over: the row-panel
    kernel takes every b % 128 == 0 (128, 256, 384, ...) with row caps
    of any size."""
    del nbc_b, pair_cap
    if dtype == torch.float64:
        return "xla"
    if (
        group_caps is not None
        and not filter_by_norm
        and not syrk_upper
        and pallas_gemm_groups.supported(block_size, dtype)
    ):
        return "groups"
    if row_caps is not None and pallas_gemm_rows.supported(block_size, dtype):
        return "rows"
    if (
        row_caps is not None
        and not filter_by_norm
        and not syrk_upper
        and pallas_gemm_fine.supported(block_size, dtype)
    ):
        return "fine"
    if block_size % 128 == 0:
        return "pallas"
    return "xla"


def matmul_precision(precision: str, device: torch.device):
    """The context of a plain f32 product (`torch.bmm`, `torch.matmul`) at
    a precision tier, as the reference's XLA dots take it: TF32 off at
    "highest" and "high" (full f32 products whatever the global flag
    says), the global setting at "default"."""
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    if precision == "default":
        return contextlib.nullcontext()
    return pallas_gemm_fine._ieee_fp32_matmul(device)


# Bound the gathered operands of the "xla" path: 2 * chunk * b^2 elements
# per operand gather and product.
_XLA_PAIR_CHUNK = 8192


def _xla_numeric_accumulate(
    a_data, b_data, a_idx, b_idx, seg, out_shape, acc_dtype, precision
):
    """Chunked gather + `bmm` + `index_add_`: pair p adds
    A[a_idx[p]] @ B[b_idx[p]] into slot seg[p]; slots >= out_shape[0] go
    to a trash row that is dropped.  f32 products run with TF32 off at
    "highest" and "high"."""
    dev = a_data.device
    n_out = out_shape[0]
    out = torch.zeros((n_out + 1,) + tuple(out_shape[1:]), dtype=acc_dtype, device=dev)
    seg = seg.long().clamp(max=n_out)
    a_idx, b_idx = a_idx.long(), b_idx.long()
    with matmul_precision(precision, dev):
        for s0 in range(0, a_idx.shape[0], _XLA_PAIR_CHUNK):
            sl = slice(s0, s0 + _XLA_PAIR_CHUNK)
            prod = torch.bmm(
                a_data[a_idx[sl]].to(acc_dtype), b_data[b_idx[sl]].to(acc_dtype)
            )
            out.index_add_(0, seg[sl], prod)
    return out[:n_out]


def _max_row_count(ids: torch.Tensor, nb_rows: int, nb_cols: int) -> torch.Tensor:
    """Largest number of stored blocks in one block-row of a sorted id
    list (0-dim int32, no host sync)."""
    rowv = torch.where(ids != SENTINEL, ids // nb_cols, nb_rows).to(torch.int32)
    start = torch.searchsorted(
        rowv, torch.arange(nb_rows + 1, dtype=torch.int32, device=ids.device),
        out_int32=True,
    )
    return (start[1:] - start[:-1]).max()


def row_overflow(b: BlockMatrix, out_ids: torch.Tensor, nb_rows_a: int, row_caps) -> torch.Tensor:
    """True when B's rows or the output's rows hold more blocks than the
    kernels' bucketed row caps: the kernels clamp B rows to the cap, so an
    undersized cap would drop products silently (0-dim bool, no host
    sync)."""
    bucket = pallas_gemm_fine._bucket
    return (
        _max_row_count(b.ids, b.nb_rows, b.nb_cols) > bucket(max(row_caps[0], 1))
    ) | (
        _max_row_count(out_ids, nb_rows_a, b.nb_cols) > bucket(max(row_caps[1], 1))
    )


def group_overflow(t: pallas_gemm_groups.GroupTables, group_caps) -> torch.Tensor:
    """True when a row group holds more A blocks, B slab blocks or output
    slots than the bucketed group caps: the group kernel clamps to them,
    so an undersized cap would give wrong blocks silently (0-dim bool, no
    host sync)."""
    bucket = pallas_gemm_fine._bucket
    _, a_gm, s_gm, c_gm = group_caps
    return (
        ((t.grp_a_start[1:] - t.grp_a_start[:-1]).max() > bucket(a_gm))
        | (t.slab_cnt.max() > bucket(s_gm))
        | ((t.grp_c_start[1:] - t.grp_c_start[:-1]).max() > bucket(c_gm))
    )


def leaf_multiplies(a_leaf_occ, b_leaf_occ, a_idx, b_idx, c_id) -> torch.Tensor:
    """Exact count of leaf products at the fine leaf size (0-dim int32):
    pair (A_ik, B_kj) multiplies, for each inner leaf index w, the
    occupied leaves of A's leaf-column w by those of B's leaf-row w.
    Chunked at `_XLA_PAIR_CHUNK` pairs to bound the [pairs, f] gathers."""
    ca = a_leaf_occ.sum(1, dtype=torch.int32)  # [capA, f]
    rb = b_leaf_occ.sum(2, dtype=torch.int32)  # [capB, f]
    pv = c_id != SENTINEL
    total = torch.zeros((), dtype=torch.int64, device=c_id.device)
    for s0 in range(0, a_idx.shape[0], _XLA_PAIR_CHUNK):
        sl = slice(s0, s0 + _XLA_PAIR_CHUNK)
        per_pair = (ca[a_idx[sl].long()] * rb[b_idx[sl].long()]).sum(-1)
        total += torch.where(pv[sl], per_pair, 0).sum()
    return total.to(torch.int32)


def spgemm(
    a: BlockMatrix,
    b: BlockMatrix,
    pair_cap: int,
    out_cap: int,
    alpha=1.0,
    transpose_a: bool = False,
    transpose_b: bool = False,
    backend: str = "auto",
    precision: str = "highest",
    tau=0.0,
    filter_by_norm: bool = False,
    gemm_cap: int | None = None,
    row_caps: tuple[int, int] | None = None,
    group_caps: tuple[int, int, int, int] | None = None,
    syrk_upper: bool = False,
    a_leaf_occ: torch.Tensor | None = None,
    b_leaf_occ: torch.Tensor | None = None,
    accum: BlockMatrix | None = None,
    beta=1.0,
    plan: SymbolicPlan | None = None,
    accum_aligned: bool = False,
):
    """C = alpha * op(A) @ op(B) [+ beta * accum]; returns (C, MultiplyInfo).

    `pair_cap` bounds the enumerated block pairs and `out_cap` the
    distinct output blocks (static capacities); overflow is reported in
    MultiplyInfo, never silent.  `plan` (from `make_plan`) skips the
    symbolic phase for fixed-structure iteration and is self-checked
    against the operands (`plan_mismatch`).  `accum` fuses the
    beta-accumulate: C's structure is the union of the product support
    and accum's, and beta*accum is added by one gather-add (on "fine", by
    the same output pass that applies alpha).  `alpha` and
    `beta` may be numbers or 0-dim tensors (no host sync either way).

    backend: "groups" (row-group kernel, b % 128 == 0; needs `group_caps`
    from `plan_groups`), "rows" (row-panel kernel, b % 128 == 0; needs
    `row_caps`), "fine" (fine kernel, leaves 16/32/64; needs `row_caps`),
    "pallas" (pair-stream kernel, b % 128 == 0), "xla" (gather + `bmm`),
    or "auto" (`resolve_backend`).  On the card an explicit kernel backend
    that does not take the leaf raises `ValueError`; CPU tensors take each
    kernel's plain version.  precision: "highest" (f32-faithful), "high"
    (bf16x3 split; full f32 on the stream kernel, as in the reference),
    "default" (one bf16 pass on the kernels); ignored for non-f32 data.

    `a_leaf_occ`/`b_leaf_occ` (from ``coarsen(..., track_leaves=True)``)
    make `n_leaf_multiplies` the exact leaf-product count at the fine
    leaf size; it is -1 without them.

    `syrk_upper` computes only the products of upper-triangle outputs
    (block row <= block column): the symbolic phase drops the other pairs,
    and "rows" skips them in the kernel (`triu`), so with a generic `plan`
    its lower slots hold no product.  "groups" and "fine" decline it, as
    in the reference.

    `filter_by_norm` skips the block products with ||A_ik||_F *
    ||B_kj||_F <= `tau` (SpAMM, the reference lineage's error-controlled
    multiply; `spamm`): the symbolic phase drops them, and "rows" skips
    them in the kernel, fed the same norms and tau^2.  Size `gemm_cap`
    with `plan_spamm` to run the surviving pairs only.  A `plan` built
    with the filter is also checked against the operands' current norms:
    a data drift that changes a keep decision sets `plan_mismatch`.
    "groups" and "fine" decline the filter.

    `accum_aligned` (with `accum`, "rows", alpha == 1 and
    ``accum.cap == out_cap``) makes C's structure the accumulator's: the
    kernel starts each slot from beta*accum and no union is formed, so
    every product block must have a slot in `accum`.  A product block
    outside it sets `plan_mismatch`: planless by a membership search,
    with a plan (``make_plan(accum_ids=accum.ids, out_cap=)``) when the
    plan's union differs from its accumulator ids.
    """
    with span("hbsm.spgemm"):
        if (a_leaf_occ is None) != (b_leaf_occ is None):
            raise ValueError("a_leaf_occ and b_leaf_occ go together")
        if transpose_a:
            a = basic.transpose(a)
        if transpose_b:
            b = basic.transpose(b)
        if a.n_cols != b.n_rows or a.block_size != b.block_size:
            raise ValueError(
                f"inner dims/block mismatch: {a.n_cols}x{a.block_size} vs "
                f"{b.n_rows}x{b.block_size}"
            )
        dev = a.device
        if backend == "auto":
            backend = resolve_backend(
                a.block_size, a.dtype, b.nb_cols, pair_cap,
                row_caps=row_caps, group_caps=group_caps,
                filter_by_norm=filter_by_norm, syrk_upper=syrk_upper,
            )
        if accum_aligned:
            if accum is None:
                raise ValueError("accum_aligned requires accum")
            if backend != "rows":
                raise ValueError(
                    f"accum_aligned requires the rows backend (got {backend!r}); "
                    "supply row_caps that fit"
                )
            if not alpha_is_one_static(alpha):
                raise ValueError("accum_aligned supports alpha == 1 only")
            if accum.cap != out_cap:
                raise ValueError(
                    f"accum_aligned needs accum.cap == out_cap ({accum.cap} != {out_cap})"
                )
        norm_filter = spamm_filter(a, b, tau) if filter_by_norm else None
        # A stale plan gathers wrong pairs: compare the id structure it was
        # built for (a capacity change counts as drift).
        plan_mismatch = torch.zeros((), dtype=torch.bool, device=dev)

        if plan is None:
            a_idx, b_idx, c_id, total, raw_total = _symbolic(
                a, b, pair_cap, norm_filter, syrk_upper)
        else:
            if plan.a_idx.shape[0] != pair_cap:
                raise ValueError(
                    f"plan built for pair_cap={plan.a_idx.shape[0]}, got {pair_cap}"
                )
            a_idx, b_idx, c_id = plan.a_idx, plan.b_idx, plan.c_id
            total, raw_total = plan.total, plan.raw_total
            if plan.a_ids is not None:
                plan_mismatch = ids_mismatch(((a.ids, plan.a_ids), (b.ids, plan.b_ids)))
            if norm_filter is not None:
                plan_mismatch = plan_mismatch | _norm_drift(plan, norm_filter, a, b, syrk_upper)
        gemm_cap = pair_cap if gemm_cap is None else min(gemm_cap, pair_cap)
        if gemm_cap < pair_cap:
            # Survivors sort before SENTINEL padding.
            a_idx, b_idx, c_id = a_idx[:gemm_cap], b_idx[:gemm_cap], c_id[:gemm_cap]
        if a_leaf_occ is not None:
            n_leaf = leaf_multiplies(a_leaf_occ, b_leaf_occ, a_idx, b_idx, c_id)
        else:
            n_leaf = torch.full((), -1, dtype=torch.int32, device=dev)

        valid_p = c_id != SENTINEL
        pos_acc = seg = None
        if accum is None:
            first = first_of_run(c_id)
            seg = torch.where(valid_p, torch.cumsum(first, 0) - 1, out_cap)
            n_unique = (first & valid_p).sum().to(torch.int32)
            out_ids_pre = torch.full((out_cap + 1,), SENTINEL, dtype=torch.int32, device=dev)
            out_ids_pre[seg.clamp(max=out_cap)] = c_id
            out_ids_pre = out_ids_pre[:out_cap]
        else:
            if (accum.n_rows, accum.n_cols) != (a.n_rows, b.n_cols):
                raise ValueError("accum shape mismatch")
            if accum.block_size != a.block_size:
                raise ValueError("accum block_size mismatch")
            if accum_aligned:
                # C's structure is the accumulator's: every product block must
                # land in one of its slots, loudly.
                out_ids_pre, n_unique = accum.ids, accum.nnz
                if plan is not None and plan.acc_ids is not None:
                    # The planned union equals the accumulator ids exactly when
                    # the product support lies inside them.
                    plan_mismatch = plan_mismatch | ids_mismatch(
                        ((accum.ids, plan.acc_ids), (plan.out_ids, plan.acc_ids)))
                else:
                    pos = torch.searchsorted(accum.ids, c_id, out_int32=True)
                    member = accum.ids[pos.clamp(max=out_cap - 1).long()] == c_id
                    plan_mismatch = plan_mismatch | torch.any(valid_p & ~member) | torch.any(
                        (accum.ids[1:] == accum.ids[:-1]) & accum.valid_mask()[1:])
            elif plan is not None and plan.out_ids is not None:
                if plan.out_ids.shape[0] != out_cap:
                    raise ValueError(
                        f"plan union built for out_cap={plan.out_ids.shape[0]}, "
                        f"got {out_cap}"
                    )
                out_ids_pre = plan.out_ids
                seg = plan.seg[:gemm_cap]
                pos_acc, n_unique = plan.pos_acc, plan.n_unique
                plan_mismatch = plan_mismatch | ids_mismatch(((accum.ids, plan.acc_ids),))
            else:
                acc_ids = torch.where(accum.valid_mask(), accum.ids, SENTINEL).to(torch.int32)
                out_ids_pre, seg, pos_acc, n_unique = basic.union_merge(
                    c_id, acc_ids, out_cap
                )
        acc_dtype = torch.promote_types(a.dtype, torch.float32)
        with span("hbsm.product"):
            if backend == "groups":
                if group_caps is None:
                    raise ValueError("backend='groups' requires group_caps (plan_groups)")
                if filter_by_norm or syrk_upper:
                    raise ValueError(
                        "backend='groups' supports neither filter_by_norm nor "
                        "syrk_upper; use the rows backend"
                    )
                g_rows, a_gm, s_gm, c_gm = (int(x) for x in group_caps)
                tables = pallas_gemm_groups.group_tables(
                    a.ids, b.ids, out_ids_pre, a.nb_rows, b.nb_rows, b.nb_cols, g_rows
                )
                out_data = pallas_gemm_groups.groups_spgemm(
                    a.ids, a.data, b.ids, b.data, out_ids_pre,
                    a.nb_rows, b.nb_rows, b.nb_cols, out_cap,
                    g_rows, a_gm, s_gm, c_gm, precision=precision, tables=tables,
                )
                rows_over = group_overflow(tables, group_caps)
            elif backend in ("rows", "fine"):
                if row_caps is None:
                    raise ValueError(f"backend={backend!r} requires row_caps (plan_spgemm_ex)")
                kargs = (
                    a.ids, a.data, b.ids, b.data, out_ids_pre,
                    a.nb_rows, b.nb_rows, b.nb_cols, out_cap, row_caps[0], row_caps[1],
                )
                if backend == "rows":
                    rkw = {}
                    if norm_filter is not None:
                        rkw = dict(zip(("a_norms2", "b_norms2", "tau2"), norm_filter))
                    if accum_aligned:
                        rkw["acc_data"] = accum.data
                        if not alpha_is_one_static(beta):
                            # The kernel accumulates onto the block it loads:
                            # pre-scale the accumulator by beta in one pass.
                            acc = accum.data.to(acc_dtype)
                            rkw["acc_data"] = (acc * basic._scalar(beta, acc)).to(torch.float32)
                    out_data = pallas_gemm_rows.rows_spgemm(
                        *kargs, precision=precision, triu=syrk_upper, **rkw
                    )
                elif filter_by_norm or syrk_upper:
                    raise ValueError(
                        "backend='fine' supports neither filter_by_norm nor syrk_upper; "
                        "use the xla backend at sub-128 leaves"
                    )
                else:
                    # One output pass (kernels/fine_epilogue.py) reads the
                    # kernel's C^T blocks as they lie and writes D canonical:
                    # alpha, the padding's zeros and beta*accum at once.
                    bs = a.block_size
                    ct = pallas_gemm_fine.fine_spgemm(
                        *kargs, precision=precision, out_layout="flat"
                    ).view(out_cap, bs, bs)
                    out_data = fine_epilogue.fine_epilogue(
                        ct, out_ids_pre, alpha, None if accum is None else accum.data,
                        pos_acc, beta, dtype=a.dtype,
                    )
                rows_over = row_overflow(b, out_ids_pre, a.nb_rows, row_caps)
            elif backend == "xla":
                out_data = _xla_numeric_accumulate(
                    a.data, b.data, a_idx, b_idx, seg,
                    (out_cap, a.block_size, b.block_size), acc_dtype, precision,
                )
                rows_over = torch.zeros((), dtype=torch.bool, device=dev)
            elif backend == "pallas":
                out_data = pallas_gemm_stream.gather_gemm_accumulate_stream(
                    a.data, b.data, a_idx, b_idx, seg, out_cap, precision=precision
                )
                rows_over = torch.zeros((), dtype=torch.bool, device=dev)
            else:
                raise ValueError(f"unknown backend {backend!r}")
        # The stream kernel writes every slot too, but is held to the
        # reference's contract, where slots no pair visits are undefined.
        exact_fill = backend in ("rows", "groups")
        fine_done = backend == "fine"  # its output pass applied alpha and beta
        if not (fine_done or (exact_fill and alpha_is_one_static(alpha)
                              and a.dtype == out_data.dtype)):
            # Keep the all-zero padding invariant and apply alpha in one pass.
            slot_valid = out_ids_pre != SENTINEL
            if accum is not None and not exact_fill:
                # Union slots that no pair reached stay zero here (beta*accum
                # lands below).
                hit = torch.zeros((out_cap + 1,), dtype=torch.bool, device=dev)
                hit[seg.long().clamp(max=out_cap)] = True
                slot_valid = slot_valid & hit[:out_cap]
            out_data = torch.where(
                slot_valid[:, None, None], out_data * basic._scalar(alpha, out_data), 0
            ).to(a.dtype)
        if accum is not None and not accum_aligned:
            # Fused beta-accumulate as a gather-add: invert pos_acc with a small
            # int scatter, gather accum's block per union slot (absent -> 0)
            # and add.  pos_acc maps each valid accum slot to a unique union
            # slot only while accum's ids are unique: check it, loudly.
            plan_mismatch = plan_mismatch | torch.any(
                (accum.ids[1:] == accum.ids[:-1]) & accum.valid_mask()[1:]
            )
            if not fine_done:
                acc_blocks = basic.gather_slots(pos_acc, accum.data, out_cap)
                out_data = out_data.to(acc_dtype)
                out_data = (
                    out_data + basic._scalar(beta, out_data) * acc_blocks.to(acc_dtype)
                ).to(a.dtype)
        c = BlockMatrix(
            ids=out_ids_pre, data=out_data, nnz=torch.clamp(n_unique, max=out_cap),
            n_rows=a.n_rows, n_cols=b.n_cols, block_size=a.block_size,
        )
        info = MultiplyInfo(
            n_block_pairs=total,
            n_out_blocks=n_unique,
            pair_overflow=(raw_total > pair_cap) | (total > gemm_cap),
            out_overflow=n_unique > out_cap,
            row_overflow=rows_over,
            plan_mismatch=plan_mismatch,
            n_leaf_multiplies=n_leaf,
        )
        return c, info


def _host_norms(m: BlockMatrix) -> np.ndarray:
    """Per-block Frobenius norms on the host (f32, from the device's
    squared norms)."""
    return np.sqrt(block_frob_squared(m).cpu().numpy())


def plan_spamm(a: BlockMatrix, b: BlockMatrix, tau: float):
    """Host-side exact plan of the norm-filtered multiply: (n_surviving
    pairs, n_out_blocks) when the pairs with ||A_ik|| * ||B_kj|| <= tau
    are skipped."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    with span("hbsm.host_plan"):
        return native.plan_spamm(
            a.ids.cpu().numpy(), _host_norms(a), b.ids.cpu().numpy(), _host_norms(b),
            a.nb_cols, b.nb_rows, b.nb_cols, tau,
        )


def spamm_error_bound(a: BlockMatrix, b: BlockMatrix, tau: float) -> float:
    """A-priori certificate of the norm-filtered multiply:
    ||A@B - spamm(A, B, tau)||_F <= this bound (the sum of the skipped
    pairs' norm products).  Host-side, exact for the given structure."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    return native.spamm_error_bound(
        a.ids.cpu().numpy(), _host_norms(a), b.ids.cpu().numpy(), _host_norms(b),
        a.nb_cols, b.nb_cols, tau,
    )


def spamm(
    a: BlockMatrix,
    b: BlockMatrix,
    tau,
    pair_cap: int,
    out_cap: int,
    gemm_cap: int | None = None,
    **kw,
):
    """Error-controlled approximate multiply C ~= A @ B, skipping the block
    products with ||A_ik||_F * ||B_kj||_F <= tau (the reference lineage's
    SpAMM for purification).  ||C - A@B||_F is at most
    `spamm_error_bound`.  Size `pair_cap` with `plan_spgemm` (the
    unfiltered enumeration) and `gemm_cap`/`out_cap` with `plan_spamm`
    (the surviving products); other keywords go to `spgemm`."""
    return spgemm(
        a, b, pair_cap=pair_cap, out_cap=out_cap, tau=tau,
        filter_by_norm=True, gemm_cap=gemm_cap, **kw,
    )


def pair_bound(a: BlockMatrix, b: BlockMatrix) -> int:
    """Cheap static upper bound on the pair count, cap(A)*cap(B) clamped
    by the dense bound.  Prefer `plan_spgemm` for tight sizing."""
    dense = a.nb_rows * a.nb_cols * b.nb_cols
    return int(min(a.cap * b.cap, dense))
