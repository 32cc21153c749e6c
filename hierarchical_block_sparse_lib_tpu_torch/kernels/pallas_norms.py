"""Per-block norm reductions: the wrappers of the Hopper kernel
``kernels/csrc/norms.cu`` and their plain PyTorch versions.

Replaces ``hierarchical_block_sparse_lib_tpu/kernels/pallas_norms.py``:
`block_frob_squared` gives f32[cap] per-block sums of squares and
`norms_and_keep` also the mask ``n2 > tau^2`` (tau squared in f32, as
the reference does), each in one read of the block tensor.  Zero
padding blocks reduce to 0, so the storage invariant holds.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  `block_frob_squared.launches` and `norms_and_keep.launches`
count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_DTYPES = (torch.float32, torch.bfloat16)


def supported(b: int, dtype) -> bool:
    """Kernel applicability, as the reference's dispatch: b % 128 == 0
    with f32 or bf16 data."""
    return b % 128 == 0 and dtype in _DTYPES


def _tau2(tau):
    """tau^2 in f32 as (device tensor [1] or None, host value): a tensor on
    the card stays there (no host sync); a number or a CPU tensor is
    squared on the host."""
    if isinstance(tau, torch.Tensor) and tau.device.type != "cpu":
        return tau.to(torch.float32).square().reshape(1).contiguous(), 0.0
    t = np.float32(float(tau))
    return None, float(t * t)


def block_frob_squared_reference(data: torch.Tensor) -> torch.Tensor:
    """The plain version: f32[cap] sums of squares."""
    return torch.sum(torch.square(data.to(torch.float32)), dim=(1, 2))


def norms_and_keep_reference(data: torch.Tensor, tau):
    """The plain version: (f32[cap] sums of squares, bool[cap] keep)."""
    n2 = block_frob_squared_reference(data)
    t2_dev, t2 = _tau2(tau)
    return n2, n2 > (t2_dev[0] if t2_dev is not None else t2)


_LIB = None


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

        lib = _build.load("norms")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hbsm_block_norms.restype = i
        lib.hbsm_block_norms.argtypes = [
            p, i, ctypes.c_longlong, i, p, p, p, ctypes.c_float, p,
        ]
        lib.hbsm_cuda_error_string.restype = ctypes.c_char_p
        lib.hbsm_cuda_error_string.argtypes = [i]
        _LIB = lib
    return _LIB


def _launch(data: torch.Tensor, with_keep: bool, tau=None):
    if data.device.type != "cuda":
        raise ValueError(f"norm kernels run on CUDA tensors, got {data.device}")
    if data.dim() != 3 or not supported(data.shape[-1], data.dtype):
        raise ValueError(
            f"norm kernel needs [cap, b, b] f32/bf16 blocks with b % 128 == 0, "
            f"got {tuple(data.shape)} {data.dtype}"
        )
    data = data.contiguous()
    if data.data_ptr() % 16:
        raise ValueError("norm kernel needs a 16-byte aligned block tensor")
    cap = data.shape[0]
    n2 = torch.empty((cap,), dtype=torch.float32, device=data.device)
    keep = torch.empty((cap,), dtype=torch.bool, device=data.device) if with_keep else None
    t2_dev, t2 = _tau2(tau) if with_keep else (None, 0.0)
    if t2_dev is not None and t2_dev.device != data.device:
        raise ValueError(f"tau on {t2_dev.device}, data on {data.device}")
    lib = _kernel_lib()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.hbsm_block_norms(
            data.data_ptr(), cap, data.shape[1] * data.shape[2],
            int(data.dtype == torch.bfloat16), n2.data_ptr(),
            keep.data_ptr() if keep is not None else None,
            t2_dev.data_ptr() if t2_dev is not None else None, t2, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"norm kernel launch failed: {lib.hbsm_cuda_error_string(err).decode()}"
        )
    return n2, keep


def block_frob_squared(data: torch.Tensor) -> torch.Tensor:
    """f32[cap] squared Frobenius norm per block of `data` [cap, b, b]."""
    if data.device.type == "cpu":
        return block_frob_squared_reference(data)
    n2, _ = _launch(data, with_keep=False)
    block_frob_squared.launches += 1
    return n2


def norms_and_keep(data: torch.Tensor, tau):
    """(norms2 f32[cap], keep bool[cap]) in one read: keep = ||block||_F >
    tau, compared as n2 > f32(tau)^2.  `tau` is a number or a 0-dim
    tensor (one on the card is read there, with no host sync)."""
    if data.device.type == "cpu":
        return norms_and_keep_reference(data, tau)
    out = _launch(data, with_keep=True, tau=tau)
    norms_and_keep.launches += 1
    return out


block_frob_squared.launches = 0
norms_and_keep.launches = 0
