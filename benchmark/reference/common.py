"""Plain PyTorch pieces the references share: dense matrices from block
lists and back, the product at the reference's precision or at the
control's, and the comparison of two block lists.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

# "f64": the reference.  "tf32": the control, the nearest precision below
# the configured float32 "highest": operands rounded to TF32's 10-bit
# mantissa, products accumulated in float32.
MODES = ("f64", "tf32")
CHUNK = 16384  # blocks per pass when comparing block lists


def work_dtype(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return torch.float64 if mode == "f64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits, the operand rounding of a TF32 tensor-core product."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def matmul(x: torch.Tensor, y: torch.Tensor, mode: str) -> torch.Tensor:
    """x @ y in float64, or in float32 on TF32-rounded operands.  TF32 in
    the library call itself is switched off, so the rounding is the only
    one and the same on every device."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if mode == "tf32":
            return round_tf32(x) @ round_tf32(y)
        return x @ y
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dense(ids: np.ndarray, data: torch.Tensor, nb: int, dtype: torch.dtype) -> torch.Tensor:
    """[nb*b, nb*b] matrix of the blocks `data` at row-major block `ids`."""
    b = data.shape[-1]
    grid = torch.zeros((nb * nb, b, b), dtype=dtype, device=data.device)
    grid.index_copy_(0, torch.as_tensor(ids, device=data.device), data.to(dtype))
    return grid.view(nb, nb, b, b).permute(0, 2, 1, 3).reshape(nb * b, nb * b)


def blocks(x: torch.Tensor, ids: np.ndarray, nb: int) -> torch.Tensor:
    """[len(ids), b, b]: the blocks of the dense `x` at block `ids`."""
    b = x.shape[0] // nb
    t = torch.as_tensor(ids, device=x.device)
    return x.view(nb, b, nb, b)[t // nb, :, t % nb, :]


def block_norms2(x: torch.Tensor, nb: int) -> torch.Tensor:
    """[nb, nb] squared Frobenius norm of every block of the dense `x`."""
    b = x.shape[0] // nb
    return x.view(nb, b, nb, b).square().sum(dim=(1, 3))


def compare_blocks(p_ids: np.ndarray, p_data: torch.Tensor,
                   r_ids: np.ndarray, r_data: torch.Tensor) -> tuple[float, int]:
    """(largest |P - R| over every block either holds, a block one side
    lacks read as zero, divided by the largest |R|; the number of block
    ids only one side holds)."""
    p_ids, r_ids = np.asarray(p_ids, np.int64), np.asarray(r_ids, np.int64)
    union = np.union1d(p_ids, r_ids)
    ids_diff = int(union.size * 2 - p_ids.size - r_ids.size)
    dev = r_data.device
    pi = torch.as_tensor(np.searchsorted(union, p_ids), device=dev)
    ri = torch.as_tensor(np.searchsorted(union, r_ids), device=dev)
    p_data = p_data.to(dev)
    scale = float(r_data.abs().max()) if r_data.numel() else 0.0
    worst = 0.0
    for lo in range(0, union.size, CHUNK):
        hi = min(lo + CHUNK, union.size)
        diff = torch.zeros((hi - lo,) + tuple(r_data.shape[1:]), dtype=torch.float64, device=dev)
        sel = (pi >= lo) & (pi < hi)
        diff.index_add_(0, pi[sel] - lo, p_data[sel].double())
        sel = (ri >= lo) & (ri < hi)
        diff.index_add_(0, ri[sel] - lo, -r_data[sel].double())
        if diff.numel():
            worst = max(worst, float(diff.abs().max()))
    return (worst / scale if scale > 0 else float("inf")), ids_diff
