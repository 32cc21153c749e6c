"""The flat block-sparse matrix representation (PyTorch port of
``hierarchical_block_sparse_lib_tpu/core/block_matrix.py``).

- ``ids``:   ``int32[cap]`` row-major block id ``brow * nb_cols + bcol``
             of each stored leaf block, sorted ascending and unique;
             padding entries hold ``SENTINEL`` (int32 max).
- ``data``:  ``dtype[cap, b, b]`` dense leaf blocks; padding blocks are
             all zero, so whole-array reductions need no mask.
- ``nnz``:   ``int32[]`` number of valid entries (a 0-dim tensor, so no
             operation has to wait for the device to learn it).

The invariants are the reference's, so the two packages compare slot
for slot.  Ids stay int32 at the API; torch's index-returning ops give
int64 and are cast back where an id or a count is stored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# Padding id: sorts after every valid block id.
SENTINEL = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class Params:
    """Construction parameters (the reference's ``Params{blocksize}``).
    The device is not a parameter: it is the constructor's `device`."""

    block_size: int = 128
    dtype: torch.dtype = torch.float32


@dataclass(frozen=True)
class BlockMatrix:
    """A block-sparse matrix as a flat, sorted list of dense leaf blocks."""

    ids: torch.Tensor  # int32[cap], sorted, SENTINEL-padded
    data: torch.Tensor  # dtype[cap, b, b], zero-padded
    nnz: torch.Tensor  # int32[] scalar
    n_rows: int = 0
    n_cols: int = 0
    block_size: int = 128

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
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    # ---- id <-> (block_row, block_col) ------------------------------------
    def block_rows(self) -> torch.Tensor:
        """Block-row of each slot (int32[cap], on the matrix's device);
        padding slots give SENTINEL."""
        return torch.where(self.valid_mask(), self.ids // self.nb_cols, SENTINEL)

    def block_cols(self) -> torch.Tensor:
        return torch.where(self.valid_mask(), self.ids % self.nb_cols, SENTINEL)

    def valid_mask(self) -> torch.Tensor:
        return self.ids != SENTINEL

    def make_id(self, brow, bcol):
        return brow * self.nb_cols + bcol

    # ---- convenience -------------------------------------------------------
    def with_data(self, data: torch.Tensor) -> "BlockMatrix":
        return dataclasses.replace(self, data=data)

    def density(self) -> torch.Tensor:
        """Fraction of blocks stored: a 0-dim float32 tensor on the matrix's
        device, computed there (no host read).  The block count is a device
        tensor too: a Python divisor would become a multiply by its
        reciprocal on the card, which rounds differently from the
        reference's division."""
        blocks = torch.full((), self.nb_rows * self.nb_cols, dtype=torch.float32,
                            device=self.nnz.device)
        return self.nnz.to(torch.float32) / blocks

    def __repr__(self):  # pragma: no cover - debug aid
        return (
            f"BlockMatrix({self.n_rows}x{self.n_cols}, b={self.block_size}, "
            f"cap={self.cap}, dtype={self.data.dtype}, device={self.device})"
        )


def resolve_device(device) -> torch.device:
    """The device a constructor builds on: the CUDA card unless the caller
    names another.  Without a card the default raises; it never falls
    back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: constructors build on the card by default; "
            "pass device='cpu' to build on the CPU"
        )
    return torch.device("cuda")


def check_geometry(n_rows: int, n_cols: int, block_size: int) -> None:
    nbr = -(-n_rows // block_size)
    nbc = -(-n_cols // block_size)
    if nbr * nbc >= SENTINEL:
        raise ValueError(
            f"block grid {nbr}x{nbc} overflows int32 id space; "
            f"use a larger block_size"
        )


def first_of_run(ids_sorted: torch.Tensor) -> torch.Tensor:
    """bool[m]: True where a sorted id differs from its predecessor."""
    first = torch.ones_like(ids_sorted, dtype=torch.bool)
    first[1:] = ids_sorted[1:] != ids_sorted[:-1]
    return first


def compact_sorted(ids: torch.Tensor, data: torch.Tensor, cap: int):
    """Sort (ids, data) rows by id, merge duplicate ids by summation, and
    pad to `cap` with SENTINEL/zeros.

    Returns (ids[cap], data[cap, ...], nnz).  Rows whose slot falls at or
    past `cap` go to a trash row `cap` that is sliced off (the port's form
    of the reference's ``mode="drop"`` scatter: torch index ops do not
    drop out-of-range indices).
    """
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    valid = ids_s != SENTINEL
    first = first_of_run(ids_s)
    slot = torch.cumsum(first, 0) - 1
    slot = torch.where(valid, slot, cap).clamp_(max=cap)
    out_ids = torch.full((cap + 1,), SENTINEL, dtype=torch.int32, device=ids.device)
    out_ids[slot] = ids_s.to(torch.int32)
    # Scatter data straight from input order: only the int64 slot map
    # moves through the permutation, the block tensor is read once.
    slot_in = torch.empty_like(slot)
    slot_in[order] = slot
    out_data = torch.zeros(
        (cap + 1,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    out_data.index_add_(0, slot_in, data)
    nnz = (first & valid).sum().to(torch.int32)
    return out_ids[:cap], out_data[:cap], nnz
