"""Block-sparse x dense products (port of ``ops/spmm.py``): Y = alpha *
A @ X for a dense X (matrix or vector).

Each stored leaf block meets X's matching row panel in one batched
`torch.bmm`; the products accumulate by block row with an `index_add_`
into a trash row ``nb_rows`` that padding blocks go to and that is
dropped.  Like the reference's, this path has no kernel of its own: the
gather is a contiguous slice per block and the product a dense batched
GEMM.
"""

from __future__ import annotations

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix, scalar_factor
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import matmul_precision


def spmm(
    a: BlockMatrix,
    x: torch.Tensor,  # [n_cols, m] dense right-hand side
    alpha=1.0,
    precision: str = "highest",
) -> torch.Tensor:
    """Y = alpha * A @ X (dense [n_rows, m] result in A's dtype)."""
    if x.shape[0] != a.n_cols:
        raise ValueError(f"shape mismatch: A is {a.n_rows}x{a.n_cols}, "
                         f"X has {x.shape[0]} rows")
    b = a.block_size
    nbr, nbc = a.nb_rows, a.nb_cols
    m = x.shape[1]
    acc = torch.promote_types(a.dtype, torch.float32)
    xp = torch.zeros((nbc * b, m), dtype=acc, device=x.device)
    xp[: x.shape[0]] = x
    xb = xp.reshape(nbc, b, m)
    valid = a.valid_mask()
    brow = torch.where(valid, a.ids // nbc, nbr).long()  # trash row nbr
    bcol = torch.where(valid, a.ids % nbc, 0).long()
    with matmul_precision(precision, a.device):
        prods = torch.bmm(a.data.to(acc), xb[bcol])  # [cap, b, m]
    out = torch.zeros((nbr + 1, b, m), dtype=acc, device=x.device)
    out.index_add_(0, brow, prods)
    y = out[:nbr].reshape(nbr * b, m)[: a.n_rows]
    return (y * scalar_factor(alpha, y)).to(a.dtype)


def spmv(
    a: BlockMatrix,
    x: torch.Tensor,  # [n_cols] dense vector
    alpha=1.0,
    precision: str = "highest",
) -> torch.Tensor:
    """y = alpha * A @ x for a dense vector x."""
    return spmm(a, x[:, None], alpha=alpha, precision=precision)[:, 0]
