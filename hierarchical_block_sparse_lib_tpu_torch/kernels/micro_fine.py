"""Micro-benchmarks of the fine-leaf kernel: the wrappers of the Hopper
kernels in ``kernels/csrc/micro_fine.cu`` and their plain PyTorch versions.

They replace the four TPU micro-kernels that sized the JAX package's
fine kernel, ``scripts/micro_fine_kernel.py::micro`` and
``scripts/micro_fine_kernel2.py::e2``, ``::e3``, ``::e12``, and time one
phase of a fine-leaf multiply each: the multiply rate on a panel
(`micro` "wide"/"quad"), the flat-block relayout (`micro` "flatten",
`e2`), the data-dependent accumulate (`e3`) and the whole inner loop per
A block (`e12`).  The scripts in ``scripts/`` drive them; no path of the
library calls them.

Each wrapper returns the TPU kernel's ``[8, 128]`` output, which is
``acc[0:8, 0:128]``, together with the whole accumulator, so that a
caller sees the work the small output hides (`e2`, which keeps no
accumulator, returns its ``[8, 128]`` alone).  The TPU kernels leave
`micro`'s accumulator uninitialised; here every accumulator starts at
zero.  Sums into one accumulator element run serially, in rep order for
`micro` and in ascending i or (e, t) order for `e3` and `e12`, in the
kernel and in the plain versions alike.  `e3` adds the same block for
every entry, so its slots depend only on how many entries each has: its
kernel counts them in one launch instead of sorting.  `e12`'s kernel is
one launch too: each block scans the slots for its own entries, in
order.  `micro` "wide" and "quad" are one function and run one kernel on
one tiling.

Precision: "highest" is f32 throughout; "default" is one bf16 pass
(operands rounded to bf16, exact products, f32 sums).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  `micro.launches`, `e2.launches`, `e3.launches` and
`e12.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import tier_bmm

REPS = 256  # micro's in-kernel repetitions (the TPU script's R)
ACC_ROWS = 4096  # e3/e12's accumulator rows: 512 slots of [8, 128]
MODES = ("wide", "quad", "flatten")
VARIANTS = ("reshape", "stack", "concat")
_PRECISIONS = {"highest": 0, "default": 2}


def rep_scales(reps: int) -> np.ndarray:
    """s_i = 1 + f32(i) * 1e-9 in f32, i < reps (the TPU kernel's guard
    against hoisting the rep loop)."""
    i = np.arange(reps, dtype=np.float32)
    return np.float32(1.0) + i * np.float32(1e-9)


def _tier(precision: str) -> int:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    return _PRECISIONS[precision]


def _micro_shapes(at, bp, mode: str):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if at.dim() != 2 or bp.dim() != 2 or at.shape[0] != 32 or bp.shape[0] != 32:
        raise ValueError(f"micro needs at [32, LA], bp [32, LB], got {tuple(at.shape)} "
                         f"{tuple(bp.shape)}")
    la, lb = at.shape[1], bp.shape[1]
    if mode == "quad" and (la % 128 or lb % 128):
        raise ValueError(f"quad needs LA, LB multiples of 128, got {la}, {lb}")
    return la, lb, (max(la, 256), max(lb, 128))


def micro_reference(at, bp, mode: str, precision: str = "highest", reps: int = REPS):
    """The plain version of `micro`: (out [8, 128], acc)."""
    la, lb, acc_shape = _micro_shapes(at, bp, mode)
    _tier(precision)
    acc = torch.zeros(acc_shape, dtype=torch.float32, device=at.device)
    scales = torch.from_numpy(rep_scales(reps)).to(at.device)
    if mode == "flatten":
        # Destination row 128 + 8(4t + c) + r, lane l reads the tile's
        # element (32t + 4r + l // 32, 32c + l % 32).
        row = torch.arange(128, device=at.device)[:, None]
        lane = torch.arange(128, device=at.device)[None, :]
        t, c, r = row // 32, (row // 8) % 4, row % 8
        src_row, src_col = 32 * t + 4 * r + lane // 32, 32 * c + lane % 32
        for i in range(reps):
            tile = acc[0:128, 0:128] + scales[i]
            acc[128:256, 0:128] += tile[src_row, src_col]
    else:
        # "quad" is the same sum as "wide", taken in 128x128 tiles.
        a, b = at.to(torch.float32), bp.to(torch.float32)
        for i in range(reps):
            prod = tier_bmm((a * scales[i]).T[None], b[None], precision)[0]
            acc[:la, :lb] += prod
    return acc[0:8, 0:128], acc


def e2_reference(x, variant: str):
    """The plain version of `e2`: x [32, 32] read row-major as [8, 128],
    by the variant's recipe."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant == "reshape":
        return x.reshape(8, 128).clone()
    if variant == "stack":
        f = torch.stack([x[q:32:4] for q in range(4)], dim=0)  # [4, 8, 32]
        return f.transpose(0, 1).reshape(8, 128)
    return torch.cat([x[r:32:4] for r in range(4)], dim=1)


def _runs(slots, n_slots: int):
    """Stable sort of entry -> slot: (order int32, run_start int32[n_slots
    + 1]); entries of slot p are order[run_start[p]:run_start[p + 1]], in
    ascending entry order.  Slots outside [0, n_slots) fall in no run."""
    sorted_slots, order = torch.sort(slots, stable=True)
    bounds = torch.arange(n_slots + 1, dtype=slots.dtype, device=slots.device)
    run_start = torch.searchsorted(sorted_slots, bounds, out_int32=True)
    return order.to(torch.int32), run_start


def _serial_slot_add(acc_slots, slots, vals):
    """acc_slots[slots[j]] += vals[j] for each entry j with a slot in
    range, serially in ascending j within a slot (the kernels' order), from
    the runs of `_runs`: one pass per rank in a run, so no pass touches a
    slot twice and every add is one f32 rounding."""
    n_slots = acc_slots.shape[0]
    order, run_start = (t.long() for t in _runs(slots, n_slots))
    pos = torch.arange(order.shape[0], device=slots.device)
    in_run = (pos >= run_start[0]) & (pos < run_start[-1])
    rank = torch.where(in_run, pos - run_start[slots[order].long().clamp(0, n_slots - 1)], -1)
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = order[rank == k]
        acc_slots.index_add_(0, slots[sel].long(), vals[sel])
    return acc_slots


def e3_reference(idx, v):
    """The plain version of `e3`: (out [8, 128], acc [4096, 128])."""
    _check_e3(idx, v)
    acc = torch.zeros((ACC_ROWS // 8, 1024), dtype=torch.float32, device=v.device)
    vals = v.reshape(1, 1024).expand(idx.shape[0], 1024)
    _serial_slot_add(acc, idx, vals)
    acc = acc.reshape(ACC_ROWS, 128)
    return acc[0:8], acc


def _e12_slots(idx, n_entries: int, nbrow: int, do_adds: bool):
    if do_adds:
        return idx
    return (torch.arange(n_entries, device=idx.device) % nbrow).to(torch.int32)


def e12_reference(a_wide, panel, idx, precision: str = "highest", do_adds: bool = True):
    """The plain version of `e12`: every leaf product X_t L_e by one
    batched product at the tier, then the serial slot adds.  Returns
    (out [8, 128], acc [4096, 128])."""
    ra, nbrow = _check_e12(a_wide, panel, idx)
    _tier(precision)
    q = torch.arange(ra * nbrow, device=a_wide.device)
    x = panel.reshape(nbrow, 32, 32)[q % nbrow]
    lg = a_wide[:, :, 0:32][q // nbrow]
    prod = tier_bmm(x, lg, precision).reshape(-1, 1024)
    acc = torch.zeros((ACC_ROWS // 8, 1024), dtype=torch.float32, device=a_wide.device)
    _serial_slot_add(acc, _e12_slots(idx, ra * nbrow, nbrow, do_adds), prod)
    acc = acc.reshape(ACC_ROWS, 128)
    return acc[0:8], acc


def _check_e3(idx, v):
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("e3 needs idx int32[R3]")
    if tuple(v.shape) != (8, 128) or v.dtype != torch.float32:
        raise ValueError(f"e3 needs v f32[8, 128], got {v.dtype}{tuple(v.shape)}")


def _check_e12(a_wide, panel, idx):
    if a_wide.dim() != 3 or a_wide.shape[1] != 32 or a_wide.shape[2] < 32:
        raise ValueError(f"e12 needs a_wide [RA, 32, >= 32], got {tuple(a_wide.shape)}")
    if panel.dim() != 2 or panel.shape[1] != 128 or panel.shape[0] % 8:
        raise ValueError(f"e12 needs panel [8 * NBROW, 128], got {tuple(panel.shape)}")
    ra, nbrow = a_wide.shape[0], panel.shape[0] // 8
    if idx.dtype != torch.int32 or tuple(idx.shape) != (ra * nbrow,):
        raise ValueError(f"e12 needs idx int32[{ra * nbrow}]")
    if a_wide.dtype != torch.float32 or panel.dtype != torch.float32:
        raise ValueError("e12 needs f32 operands")
    return ra, nbrow


_LIB = None
_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entries of micro_fine.cu and their arguments (pointers and the
# stream as c_void_p, ints as c_int).
SIGNATURES = {
    "hbsm_micro_dot": [_P] * 3 + [_I] * 6 + [_P],
    "hbsm_micro_flatten": [_P, _I, _I, _P],
    "hbsm_e2": [_P, _P, _I, _P],
    "hbsm_e3": [_P, _I, _P, _P, _I, _P],
    "hbsm_e12": [_P] * 4 + [_I] * 5 + [_P],
}


def _kernel_lib():
    global _LIB
    if _LIB is None:
        from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

        lib = _build.load("micro_fine")
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = _I, args
        lib.hbsm_cuda_error_string.restype = ctypes.c_char_p
        lib.hbsm_cuda_error_string.argtypes = [_I]
        _LIB = lib
    return _LIB


def _on_card(name: str, *tensors) -> torch.device:
    """The CUDA device of `tensors`, which must be contiguous, 16-byte
    aligned and on that one device; raise otherwise."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: operands on {t.device} and {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: need contiguous 16-byte aligned tensors")
    return device


def _launch(name: str, device, fn, *args) -> None:
    """Launch `fn` on the current stream of `device`, switching the current
    device only when it is another; raise on any CUDA error."""
    lib = _kernel_lib()
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(name, device, fn, *args)
    # The raw stream handle, from the private entry that torch.compile's
    # generated code calls (torch 2.x): building a torch.cuda.Stream object
    # instead costs a small kernel's whole launch again on the host.
    err = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.hbsm_cuda_error_string(err).decode()}")


def micro(at, bp, mode: str, precision: str = "highest", reps: int = REPS):
    """acc += sum_{i < reps} (at * s_i)^T bp ("wide": one product over the
    panel; "quad": the same sum, on the TPU in 128x128 tiles), or the
    flat-block relayout ("flatten"), into a zero accumulator [max(LA, 256),
    max(LB, 128)].  Returns (acc[0:8, 0:128], acc)."""
    if at.device.type == "cpu":
        return micro_reference(at, bp, mode, precision, reps)
    la, lb, acc_shape = _micro_shapes(at, bp, mode)
    tier = _tier(precision)
    if at.dtype != torch.float32 or bp.dtype != torch.float32:
        raise ValueError("micro needs f32 operands")
    device = _on_card("micro", at, bp)
    if mode == "flatten":
        acc = torch.zeros(acc_shape, dtype=torch.float32, device=device)
        _launch("micro", device, "hbsm_micro_flatten", acc.data_ptr(), acc_shape[1], reps)
    else:  # the kernel writes every element of acc
        acc = torch.empty(acc_shape, dtype=torch.float32, device=device)
        _launch("micro", device, "hbsm_micro_dot", at.data_ptr(), bp.data_ptr(),
                acc.data_ptr(), la, lb, *acc_shape, reps, tier)
    micro.launches += 1
    return acc[0:8, 0:128], acc


def e2(x, variant: str):
    """x [32, 32] -> [8, 128] row-major by the variant's recipe ("reshape",
    "stack" or "concat"); every recipe equals ``x.reshape(8, 128)``."""
    if x.device.type == "cpu":
        return e2_reference(x, variant)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if tuple(x.shape) != (32, 32) or x.dtype != torch.float32:
        raise ValueError(f"e2 needs x f32[32, 32], got {x.dtype}{tuple(x.shape)}")
    device = _on_card("e2", x)
    out = torch.empty((8, 128), dtype=torch.float32, device=device)
    _launch("e2", device, "hbsm_e2", x.data_ptr(), out.data_ptr(), VARIANTS.index(variant))
    e2.launches += 1
    return out


def e3(idx, v):
    """acc = 0; acc[8 idx[i] : 8 idx[i] + 8] += v for i < len(idx), serially
    (idx in [0, 512); others are dropped).  Returns (acc[0:8], acc [4096,
    128]).  One kernel launch, nothing else on the device."""
    if v.device.type == "cpu":
        return e3_reference(idx, v)
    _check_e3(idx, v)
    device = _on_card("e3", idx, v)
    acc = torch.empty((ACC_ROWS, 128), dtype=torch.float32, device=device)
    _launch("e3", device, "hbsm_e3", idx.data_ptr(), idx.shape[0], v.data_ptr(),
            acc.data_ptr(), ACC_ROWS // 8)
    e3.launches += 1
    return acc[0:8], acc


def e12(a_wide, panel, idx, precision: str = "highest", do_adds: bool = True):
    """For each A block e and panel block t, slot idx[e * NBROW + t] of the
    accumulator (slot t when not `do_adds`) += X_t L_e, with X_t the
    panel's rows 8t..8t+7 read as a row-major 32x32 and L_e =
    a_wide[e][:, 0:32]; slots are [8, 128] row-major readings of 32x32
    blocks, each summing its products serially in ascending (e, t) order
    (slots out of [0, 512) are dropped).  Returns (acc[0:8], acc [4096,
    128]).  One kernel launch, nothing else on the device: each block of
    the kernel finds its slot's entries itself."""
    if a_wide.device.type == "cpu":
        return e12_reference(a_wide, panel, idx, precision, do_adds)
    ra, nbrow = _check_e12(a_wide, panel, idx)
    tier = _tier(precision)
    device = _on_card("e12", a_wide, panel, idx)
    if a_wide.shape[2] % 4:
        raise ValueError(f"e12 needs a_wide's rows 16-byte aligned, got {a_wide.shape[2]} lanes")
    acc = torch.empty((ACC_ROWS, 128), dtype=torch.float32, device=device)
    _launch("e12", device, "hbsm_e12", idx.data_ptr() if do_adds else None,
            a_wide.data_ptr(), panel.data_ptr(), acc.data_ptr(), ra * nbrow,
            ACC_ROWS // 8, nbrow, a_wide.shape[2], tier)
    e12.launches += 1
    return acc[0:8], acc


micro.launches = 0
e2.launches = 0
e3.launches = 0
e12.launches = 0
