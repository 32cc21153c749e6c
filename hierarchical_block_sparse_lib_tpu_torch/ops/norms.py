"""Norms and trace (port of ``ops/norms.py``).  At fine leaves the JAX
package takes its jnp reduction too (its Pallas norm kernel serves only
b % 128 == 0), so these are plain torch reductions."""

from __future__ import annotations

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix


def block_frob_squared(a: BlockMatrix) -> torch.Tensor:
    """Per-stored-block squared Frobenius norm, accumulated in at least
    f32.  Padding blocks are all zero by invariant, so contribute 0."""
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.sum(torch.square(a.data.to(acc)), dim=(1, 2))


def frob_squared(a: BlockMatrix) -> torch.Tensor:
    return torch.sum(block_frob_squared(a))


def trace(a: BlockMatrix) -> torch.Tensor:
    """Sum of diagonal elements: only diagonal blocks contribute."""
    is_diag = (a.ids // a.nb_cols) == (a.ids % a.nb_cols)
    block_traces = torch.diagonal(a.data, dim1=-2, dim2=-1).sum(-1)
    return torch.sum(torch.where(a.valid_mask() & is_diag, block_traces, 0))
