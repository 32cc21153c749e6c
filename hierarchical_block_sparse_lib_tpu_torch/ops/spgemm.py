"""SpGEMM symbolic phase, operation counters and host planners (port of
``ops/spgemm.py``).

The symbolic phase replaces the reference's quadtree recursion: for each
stored A block (i,k), find B's row-k run, and enumerate every
(a_idx, b_idx) pair with a prefix sum plus a searchsorted expansion.
Only stored-by-stored pairs are enumerated, so ``n_block_pairs`` is the
reference's block-multiply counter.  The numeric phase at fine leaves is
``kernels/pallas_gemm_fine.py`` under ``ops/fine.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)


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


def spgemm_symbolic(a: BlockMatrix, b: BlockMatrix, pair_cap: int):
    """Enumerate contributing block pairs, sorted by output block id.

    Returns (a_idx, b_idx, c_id, total, raw_total): int32[pair_cap]
    arrays; entries past `total` have c_id == SENTINEL.  `raw_total` is
    the pair count before any filter (enumeration overflows iff
    raw_total > pair_cap); this port has no filter yet, so it equals
    `total`.  The norm filter and the upper-triangle mode of the JAX
    package are not ported.
    """
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
    total = offs[-1]

    # Expand: pair p belongs to A entry e = first index with offs[e] > p.
    p = torch.arange(pair_cap, dtype=i32, device=dev)
    e = torch.searchsorted(offs, p, right=True, out_int32=True)
    e_c = torch.clamp(e, max=a.cap - 1).long()
    base = torch.where(e_c > 0, offs[e_c - 1], 0)
    t = p - base
    valid_p = p < total
    a_idx = e_c
    b_idx = torch.clamp(lo[e_c] + t, max=b.cap - 1).long()
    c_id = torch.where(
        valid_p, a_row[e_c] * b.nb_cols + b_col[b_idx], SENTINEL
    ).to(i32)
    order = torch.argsort(c_id, stable=True)
    return (
        a_idx[order].to(i32),
        b_idx[order].to(i32),
        c_id[order],
        total.to(i32),
        total.to(i32),
    )


def plan_spgemm_ex(a: BlockMatrix, b: BlockMatrix):
    """Host-side exact plan: (n_pairs, n_out_blocks, max_b_row, max_c_row).
    The row maxima are `fine_matmul`'s `row_caps`."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    return native.plan_spgemm_ex(
        a.ids.cpu().numpy(), b.ids.cpu().numpy(), a.nb_cols, b.nb_rows, b.nb_cols
    )


def plan_spgemm(a: BlockMatrix, b: BlockMatrix):
    """Host-side exact symbolic plan: (n_pairs, n_out_blocks), to size
    pair_cap / out_cap."""
    from hierarchical_block_sparse_lib_tpu_torch.runtime import native

    return native.plan_spgemm(
        np.asarray(a.ids.cpu()), np.asarray(b.ids.cpu()),
        a.nb_cols, b.nb_rows, b.nb_cols,
    )
