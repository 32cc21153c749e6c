"""Pair-stream gather-GEMM-accumulate: the wrapper of the Hopper kernel
``kernels/csrc/gemm_stream.cu`` and its plain PyTorch version.

Replaces ``hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_stream.py::
gather_gemm_accumulate_stream`` and keeps its contract: over block pairs
sorted by output slot, ``out[seg[p]] += A[a_idx[p]] @ B[b_idx[p]]`` in
f32, where ``seg[p] >= out_cap`` marks a pair with no slot (padding
pairs, or products past an overflowing `out_cap`).  Where the reference
leaves a slot that no pair reaches undefined, both versions here write
zero, or the slot's block of the optional carry-in `cin`, which also
seeds every visited slot (the v1 kernel's chunked accumulate,
`kernels/pallas_gemm.py`, runs through it).

Tiers: "highest" and "high" are f32-faithful products (the reference maps
"high" to HIGHEST for this kernel): a full-f32 `bmm` in the plain
version, 3xTF32 on wgmma in the kernel (kernels/csrc/gemm_tile.cuh);
"default" rounds f32 operands to bf16 once and sums in f32; bf16 storage
is one exact pass.  `DEPTH` and
`CHUNK` are the TPU kernel's DMA-queue and SMEM-window sizes: `chunk=` is
accepted for the reference's signature and ignored.

A CPU tensor takes `gather_gemm_accumulate_stream_reference`; a CUDA
tensor launches the kernel or raises.
`gather_gemm_accumulate_stream.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
    _PRECISIONS,
    check_blocks,
    tier_bmm,
)

DEPTH = 8
CHUNK = 2048
_DTYPES = (torch.float32, torch.bfloat16)
# Pairs per gather in the plain version: bounds its [chunk, b, b] copies.
_PLAIN_CHUNK = 8192


def supported(b: int, dtype) -> bool:
    """Stream kernel applicability on the card: b a multiple of 128, f32
    or bf16 data."""
    return b % 128 == 0 and dtype in _DTYPES


def _tier(precision: str, dtype) -> str:
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if dtype == torch.bfloat16 or precision == "high":
        return "highest"
    return precision


def gather_gemm_accumulate_stream_reference(
    a_data, b_data, a_idx, b_idx, seg, out_cap: int, precision: str = "highest",
    chunk: int = CHUNK, cin=None,
) -> torch.Tensor:
    """The plain PyTorch version (same arguments), on any device: gather
    the pairs, batched `torch.bmm` at the tier, `index_add_` into
    ``out_cap + 1`` slots whose last (pairs with no slot) is dropped."""
    del chunk
    precision = _tier(precision, a_data.dtype)
    b = a_data.shape[-1]
    out = torch.zeros((out_cap + 1, b, b), dtype=torch.float32, device=a_data.device)
    if cin is not None:
        out[:out_cap] = cin
    seg = seg.long().clamp(max=out_cap)
    for s0 in range(0, a_idx.shape[0], _PLAIN_CHUNK):
        sl = slice(s0, s0 + _PLAIN_CHUNK)
        prod = tier_bmm(
            a_data[a_idx[sl].long()].to(torch.float32),
            b_data[b_idx[sl].long()].to(torch.float32), precision,
        )
        out.index_add_(0, seg[sl], prod)
    return out[:out_cap]


_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entries of gemm_stream.cu and their arguments (pointers and the
# stream as c_void_p, ints as c_int).
SIGNATURES = {
    "hbsm_stream_gemm": [_P] * 7 + [_I] * 6 + [_P],
    "hbsm_stream_gemm_config": [_I, _I, _P],
}


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

        lib = _build.load("gemm_stream")
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _I, args
        lib.hbsm_cuda_error_string.restype = ctypes.c_char_p
        lib.hbsm_cuda_error_string.argtypes = [_I]
        _LIB = lib
    return _LIB


def launch_config(dtype, precision: str) -> dict:
    """What a launch for this data type and tier gets (the keys of
    `pallas_gemm_rows.CONFIG_KEYS`), read from the library and the card."""
    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import CONFIG_KEYS

    lib = _kernel_lib()
    info = (ctypes.c_int * len(CONFIG_KEYS))()
    err = lib.hbsm_stream_gemm_config(
        int(dtype == torch.bfloat16), _PRECISIONS[_tier(precision, dtype)],
        ctypes.cast(info, ctypes.c_void_p),
    )
    if err != 0:
        raise RuntimeError(f"stream config: {lib.hbsm_cuda_error_string(err).decode()}")
    return dict(zip(CONFIG_KEYS, info))


def gather_gemm_accumulate_stream(
    a_data: torch.Tensor,  # [capA, b, b] f32 or bf16
    b_data: torch.Tensor,  # [capB, b, b], A's type
    a_idx: torch.Tensor,  # int[pairs]
    b_idx: torch.Tensor,  # int[pairs], seg-sorted together with a_idx
    seg: torch.Tensor,  # int[pairs], sorted; >= out_cap for pairs with no slot
    out_cap: int,
    precision: str = "highest",
    chunk: int = CHUNK,
    cin: torch.Tensor | None = None,  # f32[out_cap, b, b] starting values
) -> torch.Tensor:
    """f32[out_cap, b, b] segment-accumulated block products, one launch
    for any pair count."""
    device = a_data.device
    if device.type == "cpu":
        return gather_gemm_accumulate_stream_reference(
            a_data, b_data, a_idx, b_idx, seg, out_cap, precision, chunk, cin
        )
    if device.type != "cuda":
        raise ValueError(
            f"gather_gemm_accumulate_stream runs on CPU or CUDA tensors, got {device}"
        )
    b = a_data.shape[-1]
    if not supported(b, a_data.dtype):
        raise ValueError(
            f"the stream kernel needs b % 128 == 0 with f32 or bf16 data, "
            f"got b={b} {a_data.dtype}"
        )
    precision = _tier(precision, a_data.dtype)
    a_data, b_data = a_data.contiguous(), b_data.contiguous()
    cap_a, cap_b = a_data.shape[0], b_data.shape[0]
    check_blocks("a_data", a_data, (cap_a, b, b), a_data.dtype, device)
    check_blocks("b_data", b_data, (cap_b, b, b), a_data.dtype, device)
    if min(cap_a, cap_b) == 0:
        raise ValueError("the stream kernel needs operands with capacity >= 1")
    pairs = a_idx.shape[0]
    idx = []
    for name, t in (("a_idx", a_idx), ("b_idx", b_idx), ("seg", seg)):
        if t.dim() != 1 or t.shape[0] != pairs or t.device != device:
            raise ValueError(f"{name}: need a 1-D tensor of {pairs} pairs on {device}")
        idx.append(t.to(torch.int32).contiguous())
    a_idx, b_idx, seg = idx
    if cin is not None:
        check_blocks("cin", cin, (out_cap, b, b), torch.float32, device)
    out = torch.empty((out_cap, b, b), dtype=torch.float32, device=device)
    if out_cap == 0:
        return out
    # Slot s takes pairs slot_start[s] .. slot_start[s+1] - 1: seg is sorted
    # up to its no-slot tail, which the clamp makes one run of out_cap.
    slot_start = torch.searchsorted(
        seg.clamp(max=out_cap),
        torch.arange(out_cap + 1, dtype=torch.int32, device=device),
        out_int32=True,
    )
    lib = _kernel_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.hbsm_stream_gemm(
            slot_start.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(),
            a_data.data_ptr(), b_data.data_ptr(),
            cin.data_ptr() if cin is not None else None, out.data_ptr(),
            out_cap, cap_a, cap_b, b, int(a_data.dtype == torch.bfloat16),
            _PRECISIONS[precision], stream,
        )
    if err != 0:
        raise RuntimeError(
            "gather_gemm_accumulate_stream launch failed: "
            f"{lib.hbsm_cuda_error_string(err).decode()}"
        )
    gather_gemm_accumulate_stream.launches += 1
    return out


gather_gemm_accumulate_stream.launches = 0
