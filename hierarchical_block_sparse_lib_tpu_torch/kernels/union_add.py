"""The add's structural union, every block of the sum written once: the
wrapper of the Hopper kernel ``kernels/csrc/union_add.cu`` and its plain
PyTorch version.

`union_add(a_ids, a_data, b_ids, b_data, alpha, beta, cap)` gives
(ids int32[cap], data [cap, ...], nnz int32[], overflow bool[]) for
alpha*A + beta*B over the union of two sorted, unique, SENTINEL-padded id
lists: the union's ids ascending, the highest dropped past `cap`; `nnz`
the union's size clamped to `cap` and `overflow` whether it exceeded it.
Each union slot has at most one block of each operand (the storage
invariant), so a slot's block is ``fl(fl(0 + alpha*a) + beta*b)``, the
same bits as the zero-filled scatter-add of the two scaled operands.

Replaces no TPU kernel: the JAX package's add is plain XLA (concatenate,
sort, scatter-add), see the source's note.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
`union_add.launches` counts kernel calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL, gather_slots
from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

_P, _I, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
# The C entries of union_add.cu and their arguments; the scratch size
# returns a long long.
SIGNATURES = {
    "hbsm_union_add_scratch": [_I, _I, _I],
    "hbsm_union_add": [_P, _P, _I, _P, _P, _I, _L, _I, _P, _D, _P, _D, _I, _P, _P, _P, _P, _P, _P],
}
_RESTYPES = {"hbsm_union_add_scratch": _L}


def union_slots(a_ids: torch.Tensor, b_ids: torch.Tensor, cap: int):
    """The union's structure, in int arithmetic: (slot_a, slot_b, size).

    slot_a / slot_b (int64) map each row of A / B to its union slot,
    `cap` for a SENTINEL row or a slot past the capacity (the slot maps of
    `gather_slots`); `size` (int32[]) is the union's size before the
    clamp.  A row's slot is its index, plus the other operand's ids below
    it, less the common ids below it: a shared id gets one slot from both
    sides."""

    def slots(ids, other):
        valid = ids != SENTINEL
        below = torch.searchsorted(other, ids)
        hit = (valid & (torch.searchsorted(other, ids, right=True) > below)).long()
        slot = torch.arange(ids.shape[0], device=ids.device) + below - (torch.cumsum(hit, 0) - hit)
        return torch.where(valid & (slot < cap), slot, cap), hit.sum()

    slot_a, hits = slots(a_ids, b_ids)
    slot_b, _ = slots(b_ids, a_ids)
    size = ((a_ids != SENTINEL).sum() + (b_ids != SENTINEL).sum() - hits).to(torch.int32)
    return slot_a, slot_b, size


def union_add_reference(a_ids, a_data, b_ids, b_data, alpha=1.0, beta=1.0, cap=None):
    """The plain version: the slot arithmetic of `union_slots`, an int
    scatter of the ids, and each operand's scaled blocks gathered into the
    union (`gather_slots`) and added onto zeros."""
    cap = a_ids.shape[0] + b_ids.shape[0] if cap is None else cap
    slot_a, slot_b, size = union_slots(a_ids, b_ids, cap)
    ids = torch.full((cap + 1,), SENTINEL, dtype=torch.int32, device=a_ids.device)
    ids[slot_a] = a_ids.to(torch.int32)  # slot `cap` is the trash row
    ids[slot_b] = b_ids.to(torch.int32)
    term_a = gather_slots(slot_a, a_data, cap, alpha)
    term_b = gather_slots(slot_b, b_data, cap, beta)
    # A zero-filled scatter-add adds each term to +0 first (so -0 reads +0),
    # and an absent term adds +0.
    data = torch.zeros(term_a.shape, dtype=torch.promote_types(term_a.dtype, term_b.dtype),
                       device=term_a.device)
    data += term_a
    data += term_b
    return ids[:cap], data, torch.clamp(size, max=cap), size > cap


def _launch(a_ids, a_data, b_ids, b_data, alpha, beta, cap):
    dev = a_data.device
    if dev.type != "cuda":
        raise ValueError(f"union-add kernel runs on CUDA tensors, got {dev}")
    if a_data.dtype != b_data.dtype or a_data.dtype not in _build.DTYPE_CODES:
        raise ValueError(
            f"union-add kernel needs f32, bf16 or f64 data of one dtype, got "
            f"{a_data.dtype} and {b_data.dtype}"
        )
    if a_data.shape[1:] != b_data.shape[1:]:
        raise ValueError(f"block shapes differ: {tuple(a_data.shape)} {tuple(b_data.shape)}")
    for t in (a_ids, b_ids, b_data):
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
    if a_ids.dtype != torch.int32 or b_ids.dtype != torch.int32:
        raise ValueError("union-add kernel needs int32 ids")
    if (a_ids.shape[0], b_ids.shape[0]) != (a_data.shape[0], b_data.shape[0]):
        raise ValueError("ids and blocks differ in capacity")
    a_ids, b_ids = a_ids.contiguous(), b_ids.contiguous()
    a_data, b_data = a_data.contiguous(), b_data.contiguous()
    alpha_dev, alpha_val = _build.scalar_arg(alpha, a_data.dtype, dev)
    beta_dev, beta_val = _build.scalar_arg(beta, b_data.dtype, dev)
    cap_a, cap_b = a_ids.shape[0], b_ids.shape[0]
    lib = _build.bind("union_add", SIGNATURES, _RESTYPES)
    scratch = torch.empty((lib.hbsm_union_add_scratch(cap_a, cap_b, cap),),
                          dtype=torch.int32, device=dev)
    ids = torch.empty((cap,), dtype=torch.int32, device=dev)
    data = torch.empty((cap,) + tuple(a_data.shape[1:]), dtype=a_data.dtype, device=dev)
    nnz = torch.empty((), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    _build.launch(
        lib, "hbsm_union_add", "union-add kernel launch failed", dev,
        a_ids.data_ptr(), a_data.data_ptr(), cap_a, b_ids.data_ptr(), b_data.data_ptr(),
        cap_b, math.prod(a_data.shape[1:]), _build.DTYPE_CODES[a_data.dtype],
        alpha_dev.data_ptr() if alpha_dev is not None else None, alpha_val,
        beta_dev.data_ptr() if beta_dev is not None else None, beta_val,
        cap, scratch.data_ptr(), ids.data_ptr(), data.data_ptr(), nnz.data_ptr(),
        overflow.data_ptr(),
    )
    return ids, data, nnz, overflow


def union_add(a_ids, a_data, b_ids, b_data, alpha=1.0, beta=1.0, cap=None):
    """(ids, data, nnz, overflow) of alpha*A + beta*B over the union of the
    two id lists at capacity `cap` (default cap(A) + cap(B)).  `alpha` and
    `beta` are numbers or 0-dim tensors (one on the card is read there,
    with no host sync)."""
    if a_data.device.type == "cpu":
        return union_add_reference(a_ids, a_data, b_ids, b_data, alpha, beta, cap)
    cap = a_ids.shape[0] + b_ids.shape[0] if cap is None else cap
    out = _launch(a_ids, a_data, b_ids, b_data, alpha, beta, cap)
    union_add.launches += 1
    return out


union_add.launches = 0
