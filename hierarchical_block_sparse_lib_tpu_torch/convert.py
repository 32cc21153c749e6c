"""numpy <-> port conversion: how a matrix crosses between the JAX
package (``np.asarray`` of its fields) and this one.  The `*_from_numpy`
constructors build on the card unless `device` names another.

``block_matrix_from_numpy(**to_numpy(m), device=...)`` round-trips, and
so does ``fine_flat_from_numpy`` for a FineFlat.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    BlockMatrix,
    resolve_device,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.fine import FineFlat


def _fields(ids, data, nnz, device):
    device = resolve_device(device)
    return dict(
        ids=torch.from_numpy(np.array(ids, np.int32)).to(device),
        data=torch.from_numpy(np.array(data)).to(device),
        nnz=torch.tensor(int(nnz), dtype=torch.int32, device=device),
    )


def block_matrix_from_numpy(
    ids, data, nnz, n_rows: int, n_cols: int, block_size: int, device=None
) -> BlockMatrix:
    return BlockMatrix(
        **_fields(ids, data, nnz, device),
        n_rows=n_rows, n_cols=n_cols, block_size=block_size,
    )


def fine_flat_from_numpy(
    ids, data, nnz, n_rows: int, n_cols: int, block_size: int, device=None
) -> FineFlat:
    return FineFlat(
        **_fields(ids, data, nnz, device),
        n_rows=n_rows, n_cols=n_cols, block_size=block_size,
    )


def to_numpy(m) -> dict:
    """Fields of a BlockMatrix or FineFlat (either package) as numpy
    arrays and ints, keyed as the `*_from_numpy` arguments."""
    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return dict(
        ids=arr(m.ids), data=arr(m.data), nnz=int(arr(m.nnz)),
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )
