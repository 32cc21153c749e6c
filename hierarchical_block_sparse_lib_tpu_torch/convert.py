"""numpy <-> port conversion: how a matrix crosses between the JAX
package (``np.asarray`` of its fields) and this one.  The `*_from_numpy`
constructors build on the card unless `device` names another.

``block_matrix_from_numpy(**to_numpy(m), device=...)`` round-trips, and
so does ``fine_flat_from_numpy`` for a FineFlat.  A distributed matrix
crosses the same way: the JAX package stacks its shards on leading mesh
dims (``ids [P, cap]``, ``data [P, cap, b, b]``, or ``[Pr, Pc, ...]`` on a
2-D mesh); ``dist_block_matrix_from_numpy(**dist_to_numpy(m), mesh=...)``
round-trips.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    BlockMatrix,
    resolve_device,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.fine import FineFlat
from hierarchical_block_sparse_lib_tpu_torch.parallel.mesh import DistBlockMatrix, Mesh


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


def dist_block_matrix_from_numpy(
    ids, data, nnz, n_rows: int, n_cols: int, block_size: int, mesh: Mesh
) -> DistBlockMatrix:
    """A distributed matrix from the stacked layout: ``ids[*mesh_dims,
    cap]``, ``data[*mesh_dims, cap, b, b]``, ``nnz[*mesh_dims]``; shard r
    (row-major over the mesh dims) goes to the device of `mesh`'s rank r.
    The mesh dims are kept as the matrix's mesh shape, and need not be
    the mesh's own: a flat [P] layout may live on a (host, chip) mesh."""
    ids = np.asarray(ids)
    mesh_shape = tuple(ids.shape[:-1])
    ids = ids.reshape(-1, ids.shape[-1])
    data = np.asarray(data).reshape((ids.shape[0],) + np.asarray(data).shape[len(mesh_shape):])
    nnz = np.asarray(nnz).reshape(-1)
    if ids.shape[0] != mesh.size:
        raise ValueError(f"{ids.shape[0]} shards for a mesh of {mesh.size}")
    shards = tuple(
        block_matrix_from_numpy(ids[r], data[r], nnz[r], n_rows, n_cols, block_size,
                                device=mesh.device(r))
        for r in range(ids.shape[0])
    )
    return DistBlockMatrix(shards, mesh_shape)


def dist_to_numpy(m) -> dict:
    """Fields of a distributed matrix (the port's, or the JAX package's
    stacked BlockMatrix) in the stacked layout, keyed as the arguments of
    `dist_block_matrix_from_numpy`."""
    if not isinstance(m, DistBlockMatrix):
        return dict(
            ids=np.asarray(m.ids), data=np.asarray(m.data), nnz=np.asarray(m.nnz),
            n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
        )
    fields = [to_numpy(s) for s in m.shards]
    lead = tuple(m.mesh_shape)
    return dict(
        ids=np.stack([f["ids"] for f in fields]).reshape(lead + fields[0]["ids"].shape),
        data=np.stack([f["data"] for f in fields]).reshape(lead + fields[0]["data"].shape),
        nnz=np.array([f["nnz"] for f in fields], np.int32).reshape(lead),
        n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
    )

