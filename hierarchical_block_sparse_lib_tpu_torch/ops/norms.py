"""Norms and trace (port of ``ops/norms.py``).  At b % 128 == 0 with f32
or bf16 data the per-block norms take the kernel of
``kernels/pallas_norms.py`` (its plain version on the CPU), as the
reference takes its Pallas reduction on its accelerator; every other
case is a torch reduction, as the reference's jnp one."""

from __future__ import annotations

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms


def block_frob_squared(a: BlockMatrix) -> torch.Tensor:
    """Per-stored-block squared Frobenius norm, accumulated in at least
    f32.  Padding blocks are all zero by invariant, so contribute 0."""
    if pallas_norms.supported(a.block_size, a.dtype):
        return pallas_norms.block_frob_squared(a.data)
    acc = torch.promote_types(a.dtype, torch.float32)
    return torch.sum(torch.square(a.data.to(acc)), dim=(1, 2))


def frob_squared(a: BlockMatrix) -> torch.Tensor:
    return torch.sum(block_frob_squared(a))


def trace(a: BlockMatrix) -> torch.Tensor:
    """Sum of diagonal elements: only diagonal blocks contribute."""
    is_diag = (a.ids // a.nb_cols) == (a.ids % a.nb_cols)
    block_traces = torch.diagonal(a.data, dim1=-2, dim2=-1).sum(-1)
    return torch.sum(torch.where(a.valid_mask() & is_diag, block_traces, 0))
