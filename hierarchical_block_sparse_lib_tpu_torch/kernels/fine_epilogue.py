"""spgemm's fine-branch output in one pass: the wrapper of the Hopper kernel
``kernels/csrc/fine_epilogue.cu`` and its plain PyTorch version.

`fine_epilogue(ct, out_ids, alpha, acc_data, pos_acc, beta, dtype)` gives
D [out_cap, b, b] in canonical layout from the fine kernel's C^T blocks
`ct` [out_cap, b, b] (``fine_spgemm(..., out_layout="flat")`` viewed as
blocks): alpha*C in the slots of the union's ids `out_ids`, zero in its
SENTINEL padding, plus beta times the accumulator's block where `acc_data`
(canonical [n_acc, b, b]) has one, its rows landing in the union slots
`pos_acc` (past ``out_cap``: none).  Each element is the arithmetic of the
passes it replaces (the transpose, the ×alpha `where`, the gather of the
accumulator and the ×beta add), so D has their bits for every alpha and
beta.

Replaces no TPU kernel: the JAX package applies alpha and the accumulate
in XLA, see the source's note.  On the card the kernel writes D in f32,
bf16 or f64 with those passes' casts (alpha's product rounded to D's type,
the accumulate in ``promote_types(dtype, float32)``); a CPU tensor takes
the plain version.  `fine_epilogue.launches` counts kernel calls.
"""

from __future__ import annotations

import ctypes

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    accumulate_slots,
    is_static_one,
    scale_slots,
)
from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# The C entry of fine_epilogue.cu and its arguments.
SIGNATURES = {
    "hbsm_fine_epilogue": [_P, _P, _I, _I, _P, _I, _P, _I, _P, _D, _P, _D, _P, _P, _I, _P],
}


def fine_epilogue_reference(ct, out_ids, alpha=1.0, acc_data=None, pos_acc=None, beta=1.0,
                            dtype=torch.float32):
    """The plain version: the C^T blocks transposed to canonical layout, the
    ×alpha `where` pass that keeps the padding zero (skipped for a static
    alpha of 1 in the output's type), then the accumulator's blocks gathered
    into the union (`gather_slots`), scaled by beta and added, in
    ``promote_types(dtype, float32)``."""
    out = ct.transpose(-1, -2).contiguous()
    if not (is_static_one(alpha) and out.dtype == dtype):
        out = scale_slots(out, out_ids != SENTINEL, alpha, dtype)
    if acc_data is None:
        return out
    return accumulate_slots(out, pos_acc, acc_data, beta, dtype)


def _launch(ct, out_ids, alpha, acc_data, pos_acc, beta, dtype):
    dev = ct.device
    if dev.type != "cuda":
        raise ValueError(f"fine epilogue kernel runs on CUDA tensors, got {dev}")
    out_cap, b = ct.shape[0], ct.shape[-1]
    if tuple(ct.shape[1:]) != (b, b) or b not in (16, 32, 64):
        raise ValueError(f"fine epilogue needs [cap, b, b] blocks, b in (16, 32, 64), got "
                         f"{tuple(ct.shape)}")
    if ct.dtype != torch.float32 or dtype not in _build.DTYPE_CODES:
        raise ValueError(f"fine epilogue kernel needs the fine kernel's f32 blocks and an f32, "
                         f"bf16 or f64 output, got {ct.dtype} blocks and {dtype}")
    if out_ids.shape != (out_cap,) or out_ids.dtype != torch.int32 or out_ids.device != dev:
        raise ValueError("out_ids: need int32[out_cap] on the blocks' device")
    ct, out_ids = _build.aligned16(ct), out_ids.contiguous()
    acc_dtype = torch.promote_types(dtype, torch.float32)
    n_acc = 0
    if acc_data is not None:
        if tuple(acc_data.shape[1:]) != (b, b) or acc_data.device != dev:
            raise ValueError(f"accumulator blocks {tuple(acc_data.shape)} on {acc_data.device}, "
                             f"product blocks {tuple(ct.shape)} on {dev}")
        if pos_acc is None or pos_acc.shape != acc_data.shape[:1] or pos_acc.device != dev:
            raise ValueError("pos_acc: need one union slot a row of the accumulator")
        if acc_data.dtype not in (dtype, acc_dtype):
            # The former passes cast the gathered blocks; the cast commutes
            # with the gather.
            acc_data = acc_data.to(acc_dtype)
        acc_data, pos_acc = _build.aligned16(acc_data), pos_acc.to(torch.int32).contiguous()
        n_acc = acc_data.shape[0]
    alpha_dev, alpha_val = _build.scalar_arg(alpha, torch.float32, dev)
    beta_dev, beta_val = _build.scalar_arg(beta, acc_dtype, dev)
    d = torch.empty((out_cap, b, b), dtype=dtype, device=dev)
    src = torch.empty((out_cap if acc_data is not None else 0,), dtype=torch.int32, device=dev)
    codes = _build.DTYPE_CODES
    _build.launch(
        _build.bind("fine_epilogue", SIGNATURES), "hbsm_fine_epilogue",
        "fine epilogue launch failed", dev,
        ct.data_ptr(), out_ids.data_ptr(), out_cap, b,
        acc_data.data_ptr() if acc_data is not None else None,
        codes[acc_data.dtype] if acc_data is not None else codes[dtype],
        pos_acc.data_ptr() if acc_data is not None else None, n_acc,
        alpha_dev.data_ptr() if alpha_dev is not None else None, alpha_val,
        beta_dev.data_ptr() if beta_dev is not None else None, beta_val,
        src.data_ptr(), d.data_ptr(), codes[dtype],
    )
    return d


def fine_epilogue(ct, out_ids, alpha=1.0, acc_data=None, pos_acc=None, beta=1.0,
                  dtype=torch.float32):
    """D [out_cap, b, b], canonical: alpha*C^T's blocks transposed, zero in
    the padding of `out_ids`, plus beta * `acc_data`'s blocks through
    `pos_acc` when it is given.  `alpha` and `beta` are numbers or 0-dim
    tensors (one on the card is read there, with no host sync).  D is of
    `dtype`: f32, bf16 or f64 on the card, any type on the CPU."""
    if ct.device.type == "cpu":
        return fine_epilogue_reference(ct, out_ids, alpha, acc_data, pos_acc, beta, dtype)
    out = _launch(ct, out_ids, alpha, acc_data, pos_acc, beta, dtype)
    fine_epilogue.launches += 1
    return out


fine_epilogue.launches = 0
