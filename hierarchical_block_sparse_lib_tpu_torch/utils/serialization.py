"""Save / load of a BlockMatrix as one npz (port of
``utils/serialization.py``).

The file format is the JAX package's, key for key (`format_version` 1,
the valid prefix of `ids` and `data`, `n_rows`, `n_cols`, `block_size`),
so a file written by either package loads in the other.  numpy has no
bfloat16: the JAX package writes a bfloat16 payload as its raw 2-byte
elements (numpy dtype ``|V2``), and this module writes and reads the same
bytes through a 16-bit integer view.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    resolve_device,
)

_FORMAT_VERSION = 1
# numpy's dtype of a bfloat16 payload in the file: raw 2-byte elements.
_BF16_ON_DISK = np.dtype("V2")


def _to_numpy(data: torch.Tensor) -> np.ndarray:
    if data.dtype == torch.bfloat16:
        return data.cpu().view(torch.int16).numpy().view(_BF16_ON_DISK)
    return data.cpu().numpy()


def _from_numpy(data: np.ndarray) -> torch.Tensor:
    if data.dtype == _BF16_ON_DISK:
        return torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    if data.dtype.kind == "V":
        raise ValueError(f"unsupported payload dtype {data.dtype} (only bfloat16 as |V2)")
    return torch.from_numpy(data)


def save(path: str, m: BlockMatrix, compress: bool = True) -> None:
    """Write a BlockMatrix to `path` (.npz): only the valid prefix (nnz
    blocks), so files are sized by content, not capacity."""
    nnz = int(m.nnz)
    payload = dict(
        format_version=_FORMAT_VERSION,
        ids=m.ids[:nnz].cpu().numpy(),
        data=_to_numpy(m.data[:nnz]),
        n_rows=m.n_rows,
        n_cols=m.n_cols,
        block_size=m.block_size,
    )
    writer = np.savez_compressed if compress else np.savez
    writer(path, **payload)


def load(path: str, cap: int | None = None, dtype=None, device=None) -> BlockMatrix:
    """Load a BlockMatrix saved by `save` (either package's), on the card
    unless `device` names another.  `cap` (>= stored nnz) sets the storage
    capacity (default: the stored block count); `dtype` casts the
    payload."""
    with np.load(path) as z:
        if int(z["format_version"]) != _FORMAT_VERSION:
            raise ValueError(f"unknown format version {z['format_version']}")
        ids = z["ids"]
        data = _from_numpy(z["data"])
        n_rows = int(z["n_rows"])
        n_cols = int(z["n_cols"])
        block_size = int(z["block_size"])
    device = resolve_device(device)
    nnz = ids.shape[0]
    cap = max(cap if cap is not None else nnz, 1)
    if cap < nnz:
        raise ValueError(f"cap={cap} < stored blocks {nnz}")
    if dtype is not None:
        data = data.to(dtype)
    full_ids = torch.full((cap,), SENTINEL, dtype=torch.int32, device=device)
    full_ids[:nnz] = torch.from_numpy(ids.astype(np.int32)).to(device)
    full_data = torch.zeros((cap,) + tuple(data.shape[1:]), dtype=data.dtype, device=device)
    full_data[:nnz] = data.to(device)
    return BlockMatrix(
        ids=full_ids,
        data=full_data,
        nnz=torch.tensor(nnz, dtype=torch.int32, device=device),
        n_rows=n_rows,
        n_cols=n_cols,
        block_size=block_size,
    )
