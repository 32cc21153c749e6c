"""Norms, trace, counts and subtree norms (port of ``ops/norms.py``).  At
b % 128 == 0 with f32 or bf16 data the per-block norms take the kernel of
``kernels/pallas_norms.py`` (its plain version on the CPU), as the
reference takes its Pallas reduction on its accelerator; every other
case is a torch reduction, as the reference's jnp one.

The two segment sums (by quadtree node in `subtree_frob_squared`, by
block row in `gershgorin_bound`) sort by key and reduce each segment in
one pass, never with a float scatter-add: a sum whose order changed from
run to run could flip a subtree truncation's keep decision."""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core import morton
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


def frob_norm(a: BlockMatrix) -> torch.Tensor:
    return torch.sqrt(frob_squared(a))


def trace(a: BlockMatrix) -> torch.Tensor:
    """Sum of diagonal elements: only diagonal blocks contribute."""
    is_diag = (a.ids // a.nb_cols) == (a.ids % a.nb_cols)
    block_traces = torch.diagonal(a.data, dim1=-2, dim2=-1).sum(-1)
    return torch.sum(torch.where(a.valid_mask() & is_diag, block_traces, 0))


def nnz_blocks(a: BlockMatrix) -> torch.Tensor:
    """Stored (non-zero) leaf block count: the reference's `get_nnz`."""
    return a.nnz


def squared_threshold(tau, dtype=torch.float32):
    """tau^2 at the norms' accumulation type `dtype`: a tensor is squared
    on its own device (no host sync); a number is squared on the host, in
    f32 when `dtype` is f32, as the reference squares ``f32(tau)``."""
    if isinstance(tau, torch.Tensor):
        return torch.square(tau.to(dtype))
    if dtype == torch.float32:
        t = np.float32(tau)
        return float(t * t)
    return float(tau) ** 2


def segment_sum(values: torch.Tensor, keys: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Sum of the rows of `values` per key in [0, n_segments): a stable
    sort by key, then one reduction per segment, in index order within a
    segment.  Deterministic on every device."""
    order = torch.argsort(keys, stable=True)
    lengths = torch.bincount(keys.long(), minlength=n_segments)
    return torch.segment_reduce(values[order], "sum", lengths=lengths, unsafe=True)


def _subtree_keys(a: BlockMatrix, level: int) -> torch.Tensor:
    """The level-`level` quadtree-node key of each stored block; padding
    blocks get the trash key 4**level."""
    nb = max(a.nb_rows, a.nb_cols)
    depth = max(int(nb - 1).bit_length(), level)
    code = morton.encode(a.ids // a.nb_cols, a.ids % a.nb_cols)
    keys = morton.subtree_key(code, depth, level)
    return torch.where(a.valid_mask(), keys, 4**level)


def subtree_node_norms2(a: BlockMatrix, level: int):
    """(keys[cap], norms2[4**level + 1]): each block's level-`level` node
    key and the squared norm of every node; the last entry sums the
    padding blocks (all zero)."""
    keys = _subtree_keys(a, level)
    return keys, segment_sum(block_frob_squared(a), keys, 4**level + 1)


def subtree_frob_squared(a: BlockMatrix, level: int):
    """Squared Frobenius norm of every quadtree node at `level`.

    Returns (keys[cap], norms2[4**level]): `keys` is the level-`level`
    node key of each stored block (4**level for padding); `norms2[k]` the
    squared norm of node k.  Level 0 is the root (== frob_squared)."""
    keys, norms2 = subtree_node_norms2(a, level)
    return keys, norms2[: 4**level]


def gershgorin_bound(a: BlockMatrix) -> torch.Tensor:
    """Upper bound on the spectral radius: max_i sum_j |A_ij|
    (Gershgorin), the scaling that puts spectrum(A / bound) in [-1, 1]
    for the Chebyshev and Newton-Schulz iterations."""
    acc = torch.promote_types(a.dtype, torch.float32)
    row_abs = torch.sum(torch.abs(a.data.to(acc)), dim=2)  # [cap, b]
    brow = torch.where(a.valid_mask(), a.ids // a.nb_cols, a.nb_rows)
    per_row = segment_sum(row_abs, brow, a.nb_rows + 1)[: a.nb_rows]
    return torch.max(per_row)
