"""Flat-resident fine-leaf chains, b in {16, 32, 64} (port of
``ops/fine.py``).

`FineFlat` keeps the reference's transposed-flat payload convention at
the API: ``data[s]`` is ``[b*b/128, 128]`` and holds ``block_s^T``
row-major, so `fine_pack`/`fine_unpack` round-trip and compare array for
array with the JAX package.  The multiply reads and writes that memory as
it is (kernels/pallas_gemm_fine.py).  The elementwise and structural
chain ops (add, scale, truncate, norms) move or reduce whole blocks, so
they run the BlockMatrix ops on a flat-payload view.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    first_of_run,
)
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
    fine_spgemm,
    fine_tables,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops import truncate as trunc_mod
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    MultiplyInfo,
    spgemm_symbolic,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import row_overflow as _row_overflow
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class FineFlat:
    """A fine-leaf block matrix with transposed-flat payloads:
    ``data[s]`` holds ``flat(block_s^T)`` as ``[b*b/128, 128]``; ids and
    nnz as in BlockMatrix."""

    ids: torch.Tensor  # int32[cap], sorted, SENTINEL-padded
    data: torch.Tensor  # f32[cap, b*b/128, 128], zero-padded
    nnz: torch.Tensor  # int32[]
    n_rows: int = 0
    n_cols: int = 0
    block_size: int = 32

    @property
    def cap(self) -> int:
        return self.ids.shape[0]

    @property
    def nb_rows(self) -> int:
        return -(-self.n_rows // self.block_size)

    @property
    def nb_cols(self) -> int:
        return -(-self.n_cols // self.block_size)

    @property
    def fr(self) -> int:
        """Flat rows of one payload: ``b*b // 128``."""
        return (self.block_size * self.block_size) // 128

    @property
    def device(self) -> torch.device:
        return self.data.device


def fine_pack(a: BlockMatrix) -> FineFlat:
    """Canonical -> transposed-flat."""
    b = a.block_size
    if b not in (16, 32, 64):
        raise ValueError(f"fine layout needs b in (16,32,64), got {b}")
    fr = (b * b) // 128
    return FineFlat(
        ids=a.ids,
        data=a.data.to(torch.float32).transpose(-1, -2).reshape(a.cap, fr, 128),
        nnz=a.nnz,
        n_rows=a.n_rows,
        n_cols=a.n_cols,
        block_size=b,
    )


def fine_unpack(f: FineFlat) -> BlockMatrix:
    """Transposed-flat -> canonical."""
    b = f.block_size
    return BlockMatrix(
        ids=f.ids,
        data=f.data.reshape(f.cap, b, b).transpose(-1, -2).contiguous(),
        nnz=f.nnz,
        n_rows=f.n_rows,
        n_cols=f.n_cols,
        block_size=b,
    )


def _shim(f: FineFlat) -> BlockMatrix:
    """BlockMatrix view with flat payloads, only for the ops below that
    move or reduce whole blocks and never index inside one."""
    return BlockMatrix(
        ids=f.ids, data=f.data, nnz=f.nnz,
        n_rows=f.n_rows, n_cols=f.n_cols, block_size=f.block_size,
    )


def _unshim(m: BlockMatrix, b: int) -> FineFlat:
    return FineFlat(
        ids=m.ids, data=m.data, nnz=m.nnz,
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=b,
    )


def fine_add(
    a: FineFlat, b: FineFlat, alpha=1.0, beta=1.0, cap: int | None = None
) -> FineFlat:
    """C = alpha*A + beta*B (structural union, flat payloads)."""
    return _unshim(
        basic.add(_shim(a), _shim(b), alpha=alpha, beta=beta, cap=cap),
        a.block_size,
    )


def fine_scale(a: FineFlat, alpha) -> FineFlat:
    return _unshim(basic.scale(_shim(a), alpha), a.block_size)


def fine_frob_squared(a: FineFlat) -> torch.Tensor:
    """Sum of squares is payload-layout invariant."""
    return torch.sum(torch.square(a.data.to(torch.float32)))


def fine_trace(a: FineFlat) -> torch.Tensor:
    """Matrix trace on transposed-flat payloads: trace(X^T) == trace(X),
    and diagonal element i of a flat [fr, 128] payload sits at
    (i // f, b*(i % f) + i) with f = 128/b — a static gather."""
    b = a.block_size
    f = 128 // b
    ii = torch.arange(b, device=a.device)
    block_traces = a.data[:, ii // f, b * (ii % f) + ii].sum(-1)
    is_diag = (a.ids // a.nb_cols) == (a.ids % a.nb_cols)
    return torch.sum(
        torch.where(
            (a.ids != SENTINEL) & is_diag, block_traces.to(torch.float32), 0.0
        )
    )


def fine_truncate(a: FineFlat, tau, cap: int | None = None) -> FineFlat:
    """Leaf truncation (block frob norms are layout-invariant).  With
    `cap`, the kept-count that `truncate` returns alongside the matrix is
    dropped here, as in the reference: a caller that needs it truncates
    the canonical matrix."""
    out = trunc_mod.truncate(_shim(a), tau, cap=cap)
    if cap is not None:
        out = out[0]
    return _unshim(out, a.block_size)


@dataclass(frozen=True)
class FinePlan:
    """Frozen structural plan for `fine_matmul`: the output structure and
    the kernel's row tables.  Valid while both operands keep exactly the
    recorded id structure; staleness is checked on use."""

    out_ids: torch.Tensor  # int32[out_cap] sorted product support
    n_unique: torch.Tensor  # int32[]
    total: torch.Tensor  # int32[] pairs
    raw_total: torch.Tensor  # int32[]
    a_ids: torch.Tensor
    b_ids: torch.Tensor
    tables: tuple  # fine_tables(...) output (7 int32 tensors)
    row_overflow: torch.Tensor  # bool[] — row caps checked at plan time


def _structure(sa: BlockMatrix, sb: BlockMatrix, pair_cap, out_cap, row_caps):
    """Symbolic phase -> (out_ids, n_unique, total, raw_total, row_overflow)."""
    with span("hbsm.symbolic"):
        _, _, c_id, total, raw_total = spgemm_symbolic(sa, sb, pair_cap)
        valid_p = c_id != SENTINEL
        first = first_of_run(c_id)
        seg = torch.where(valid_p, torch.cumsum(first, 0) - 1, out_cap).clamp_(max=out_cap)
        n_unique = (first & valid_p).sum().to(torch.int32)
        out_ids = torch.full((out_cap + 1,), SENTINEL, dtype=torch.int32, device=c_id.device)
        out_ids[seg] = c_id
        out_ids = out_ids[:out_cap]
        return out_ids, n_unique, total, raw_total, _row_overflow(
            sb, out_ids, sa.nb_rows, row_caps
        )


def make_fine_plan(
    a, b, pair_cap: int, out_cap: int, row_caps: tuple[int, int]
) -> FinePlan:
    """Plan a fixed-structure fine multiply (operands: FineFlat or
    BlockMatrix; only ids and geometry matter)."""
    sa = a if isinstance(a, BlockMatrix) else _shim(a)
    sb = b if isinstance(b, BlockMatrix) else _shim(b)
    out_ids, n_unique, total, raw_total, row_overflow = _structure(
        sa, sb, pair_cap, out_cap, row_caps
    )
    tables = fine_tables(
        sa.ids, sb.ids, out_ids, sa.nb_rows, sb.nb_rows, sb.nb_cols, sb.block_size
    )
    return FinePlan(
        out_ids=out_ids, n_unique=n_unique, total=total,
        raw_total=raw_total, a_ids=sa.ids, b_ids=sb.ids, tables=tables,
        row_overflow=row_overflow,
    )


def fine_matmul(
    a: FineFlat,
    b: FineFlat,
    pair_cap: int,
    out_cap: int,
    row_caps: tuple[int, int],
    alpha=1.0,
    precision: str = "highest",
    plan: FinePlan | None = None,
):
    """C = alpha * A @ B on flat payloads through the fine kernel; returns
    (FineFlat, MultiplyInfo).  `plan` (make_fine_plan) freezes the whole
    structural cost, so a planned multiply is numeric only."""
    with span("hbsm.fine_matmul"):
        if a.n_cols != b.n_rows or a.block_size != b.block_size:
            raise ValueError("inner dims/block mismatch")
        dev = a.device
        plan_mismatch = torch.zeros((), dtype=torch.bool, device=dev)
        tables = None
        if plan is None:
            out_ids, n_unique, total, raw_total, row_overflow = _structure(
                _shim(a), _shim(b), pair_cap, out_cap, row_caps
            )
        else:
            if plan.out_ids.shape[0] != out_cap:
                raise ValueError("plan out_cap mismatch")
            out_ids = plan.out_ids
            n_unique, total, raw_total = plan.n_unique, plan.total, plan.raw_total
            tables = plan.tables
            row_overflow = plan.row_overflow
            for got, want in ((a.ids, plan.a_ids), (b.ids, plan.b_ids)):
                if got.shape != want.shape:
                    plan_mismatch = torch.ones_like(plan_mismatch)
                else:
                    plan_mismatch = plan_mismatch | torch.any(got != want)
        with span("hbsm.product"):
            out_data = fine_spgemm(
                a.ids, a.data, b.ids, b.data, out_ids,
                a.nb_rows, b.nb_rows, b.nb_cols, out_cap,
                row_caps[0], row_caps[1], precision=precision,
                block_size=a.block_size, out_layout="flat", alpha=alpha,
                tables=tables,
            )
        c = FineFlat(
            ids=out_ids, data=out_data, nnz=torch.clamp(n_unique, max=out_cap),
            n_rows=a.n_rows, n_cols=b.n_cols, block_size=a.block_size,
        )
        info = MultiplyInfo(
            n_block_pairs=total,
            n_out_blocks=n_unique,
            pair_overflow=raw_total > pair_cap,
            out_overflow=n_unique > out_cap,
            row_overflow=row_overflow,
            plan_mismatch=plan_mismatch,
            n_leaf_multiplies=total,
        )
        return c, info


def fine_sp2_step(
    x: FineFlat,
    tau,
    pair_cap: int,
    out_cap: int,
    row_caps: tuple[int, int],
    target_trace,
    precision: str = "highest",
    cap: int | None = None,
    plan: FinePlan | None = None,
):
    """One SP2 purification step on the flat engine:
    X' = trunc((2s-1)*X^2 + (2-2s)*X), s = [trace(X) > target].
    Returns (FineFlat, (trace, MultiplyInfo))."""
    t = fine_trace(x)
    s = (t > torch.as_tensor(target_trace, dtype=torch.float32)).to(torch.float32)
    x2, info = fine_matmul(
        x, x, pair_cap=pair_cap, out_cap=out_cap, row_caps=row_caps,
        precision=precision, plan=plan,
    )
    y = fine_add(x2, x, alpha=2.0 * s - 1.0, beta=2.0 - 2.0 * s,
                 cap=out_cap + x.cap)
    y = fine_truncate(y, tau, cap=cap if cap is not None else x.cap)
    return y, (t, info)
