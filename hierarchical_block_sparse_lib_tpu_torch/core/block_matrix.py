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


def run_slots(ids_sorted: torch.Tensor, cap: int):
    """The slots of sorted ids with repeats: (slot, out_ids, n_unique).

    `slot` (int64[m]) is each row's slot in the union of its runs, unclamped
    (valid rows past the capacity keep their number, >= cap) and `cap` for a
    SENTINEL row; clamp it to `cap` to index a store with a trash row
    `cap`.  `out_ids` (int32[cap]) holds each run's id in its slot, SENTINEL
    after the last; `n_unique` (int32[]) counts the runs, before the clamp.
    SENTINEL rows sort last, so counting every run's first row numbers the
    valid runs alike."""
    valid = ids_sorted != SENTINEL
    first = first_of_run(ids_sorted)
    slot = torch.where(valid, torch.cumsum(first, 0) - 1, cap)
    n_unique = (first & valid).sum().to(torch.int32)
    out_ids = torch.full((cap + 1,), SENTINEL, dtype=torch.int32, device=ids_sorted.device)
    out_ids[slot.clamp(max=cap)] = ids_sorted.to(torch.int32)
    return slot, out_ids[:cap], n_unique


def ids_mismatch(pairs) -> torch.Tensor:
    """True when any (operand ids, ids a plan was built for) pair differs,
    in shape or in value: a stale plan's `plan_mismatch` (0-dim bool on
    the operands' device, no host sync)."""
    mism = torch.zeros((), dtype=torch.bool, device=pairs[0][0].device)
    for got, want in pairs:
        if got.shape != want.shape:  # a capacity change counts as drift
            mism = torch.ones_like(mism)
        else:
            mism = mism | torch.any(got != want)
    return mism


def has_duplicate_ids(ids: torch.Tensor) -> torch.Tensor:
    """True when sorted ids repeat a valid id (0-dim bool, no host sync):
    a slot map from them puts two blocks in one slot."""
    return torch.any((ids[1:] == ids[:-1]) & (ids[1:] != SENTINEL))


def compact_sorted(ids: torch.Tensor, data: torch.Tensor, cap: int):
    """Sort (ids, data) rows by id, merge duplicate ids by summation, and
    pad to `cap` with SENTINEL/zeros.

    Returns (ids[cap], data[cap, ...], nnz).  Rows whose slot falls at or
    past `cap` go to a trash row `cap` that is sliced off (the port's form
    of the reference's ``mode="drop"`` scatter: torch index ops do not
    drop out-of-range indices).
    """
    order = torch.argsort(ids, stable=True)
    slot, out_ids, nnz = run_slots(ids[order], cap)
    slot.clamp_(max=cap)
    # Scatter data straight from input order: only the int64 slot map
    # moves through the permutation, the block tensor is read once.
    slot_in = torch.empty_like(slot)
    slot_in[order] = slot
    out_data = torch.zeros(
        (cap + 1,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device
    )
    out_data.index_add_(0, slot_in, data)
    return out_ids, out_data[:cap], nnz


def is_static_one(x) -> bool:
    """True for a number equal to 1, which scales by nothing: no pass runs
    for it.  A tensor is never a static one (reading it would sync)."""
    return isinstance(x, (int, float)) and float(x) == 1.0


def scalar_factor(x, like: torch.Tensor):
    """`x` (a number or a 0-dim tensor) as a factor for `like`: a tensor
    is cast to `like`'s dtype on its own device (a 0-dim tensor scales a
    tensor on any device without a host sync); a number stays a number."""
    return x.to(like.dtype) if isinstance(x, torch.Tensor) else x


def gather_slots(slot: torch.Tensor, data: torch.Tensor, cap: int, factor=1.0) -> torch.Tensor:
    """factor * data's row for every one of `cap` union slots, zero where
    none lands; `slot` maps data's rows to union slots (>= cap: none).  The
    slot map is inverted by a small int scatter (slot `cap` is the trash
    row), then the rows move by one gather: no float scatter-add.  A
    tensor `factor` is cast to data's dtype."""
    n = data.shape[0]
    src = torch.full((cap + 1,), n, dtype=torch.int64, device=data.device)
    src[slot.long().clamp(max=cap)] = torch.arange(n, device=data.device)
    src = src[:cap]
    if n == 0:
        return data.new_zeros((cap,) + tuple(data.shape[1:]))
    rows = data[src.clamp(max=n - 1)]
    if not is_static_one(factor):
        rows = rows * scalar_factor(factor, rows)
    present = (src < n).view((-1,) + (1,) * (data.dim() - 1))
    return torch.where(present, rows, 0)


def scale_slots(out: torch.Tensor, slot_valid: torch.Tensor, alpha, dtype) -> torch.Tensor:
    """alpha * out's blocks [cap, b, b] where `slot_valid` (bool[cap]) holds,
    zero elsewhere, in `dtype`: a product's alpha pass, which keeps the
    padding's blocks zero."""
    return torch.where(slot_valid[:, None, None], out * scalar_factor(alpha, out), 0).to(dtype)


def accumulate_slots(out: torch.Tensor, pos_acc: torch.Tensor, acc_data: torch.Tensor, beta,
                     dtype) -> torch.Tensor:
    """out + beta * the accumulator's blocks, gathered into out's slots
    through `pos_acc` (`gather_slots`), in ``promote_types(dtype, float32)``,
    then cast to `dtype`: the beta-accumulate of a product over the union
    of its support with the accumulator's."""
    acc_dtype = torch.promote_types(dtype, torch.float32)
    acc_blocks = gather_slots(pos_acc, acc_data, out.shape[0])
    out = out.to(acc_dtype)
    return (out + scalar_factor(beta, out) * acc_blocks.to(acc_dtype)).to(dtype)
