"""Eager front door of the multiply (port of ``ops/matmul.py``): exact host
planning of the capacities, then `spgemm` with the caps that let "auto"
pick a kernel.

The choice of backend is the reference's: a row-group plan is asked for
only when the product has fewer than 16 block pairs per A block-row (the
regime where the TPU measured the group kernel ahead), and "auto" then
prefers groups, then rows, then the stream kernel (`resolve_backend`).
Both packages therefore pick the same backend on the same input; the
H100 times that would re-decide the rule are in PERF.md.
"""

from __future__ import annotations

import dataclasses

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_groups import (
    plan_groups,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    plan_spgemm_ex,
    plan_syrk,
    spgemm,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


def matmul(
    a: BlockMatrix,
    b: BlockMatrix,
    alpha=1.0,
    transpose_a: bool = False,
    transpose_b: bool = False,
    precision: str = "highest",
    backend: str = "auto",
):
    """C = alpha * op(A) @ op(B), exactly sized.  Returns (C, MultiplyInfo).

    Plans on the host for every call (the planner reads the ids); in a
    loop over a fixed structure use `spgemm` with precomputed capacities
    and a `make_plan` plan instead."""
    with span("hbsm.matmul"):
        ae = basic.transpose(a) if transpose_a else a
        be = basic.transpose(b) if transpose_b else b
        pc, oc, mbr, mcr = plan_spgemm_ex(ae, be)
        gplan = plan_groups(ae, be) if pc < 16 * max(ae.nb_rows, 1) else None
        return spgemm(
            ae, be, pair_cap=max(pc, 1), out_cap=max(oc, 1), alpha=alpha,
            precision=precision, backend=backend, row_caps=(mbr, mcr),
            group_caps=gplan.caps if gplan is not None else None,
        )


def syrk(a: BlockMatrix, alpha=1.0, transpose: bool = False,
         precision: str = "highest", backend: str = "auto", full: bool = True):
    """Symmetric rank-k product C = alpha * A @ A^T (A^T @ A with
    `transpose=True`), computing only upper-triangle (block row <= block
    column) outputs, about half the leaf products of the generic multiply;
    the lower triangle is mirrored afterwards as C_ji = C_ij^T (a
    transpose and a union add, no products).  At leaves a multiple of 128
    wide "auto" runs it on the row-panel kernel with its `triu` skip.

    With `full=False` only the upper triangle is returned.
    `info.n_block_pairs` counts the products actually done (upper pairs).
    Returns (C, MultiplyInfo)."""
    ae = basic.transpose(a) if transpose else a
    at = basic.transpose(ae)
    plan = plan_syrk(ae)
    cu, info = spgemm(
        ae, at, pair_cap=max(plan.pairs_raw, 1), gemm_cap=max(plan.pairs_upper, 1),
        out_cap=max(plan.out_upper, 1), alpha=alpha, precision=precision,
        backend=backend, row_caps=(plan.max_b_row, plan.max_c_row), syrk_upper=True,
    )
    if not full:
        return cu, info
    low = basic.transpose(basic.triu(cu, strict=True))
    c, add_ovf = basic.add_with_info(cu, low, cap=max(plan.out_full, 1))
    return c, dataclasses.replace(info, out_overflow=info.out_overflow | add_ovf)
