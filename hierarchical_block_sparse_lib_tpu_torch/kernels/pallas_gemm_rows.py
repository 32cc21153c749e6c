"""Row-panel SpGEMM at leaves a multiple of 128 wide: the wrapper of the
Hopper kernel ``kernels/csrc/gemm_rows.cu`` and its plain PyTorch version.

Replaces ``hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_rows.py::
rows_spgemm`` and keeps its contract: products C(i,j) = sum_k A(i,k)
B(k,j) land in the slots of `out_ids` (sorted distinct ids; with a fused
accumulate, the union of the product's and the accumulator's support),
a slot no product reaches is zero (or its `acc_data` block), SENTINEL
tail slots are zero, and B rows are seen up to the bucketed row cap
`b_row_max`.  Options: the SpAMM skip (`a_norms2`, `b_norms2`, `tau2`:
a pair runs only when ``an2 * bn2 > tau2`` in f32), `triu` (only slots
with j >= i get products) and `acc_data` (each valid slot starts from
the aligned accumulator).  The output is f32.

Tiers on the card (kernels/csrc/gemm_tile.cuh): "highest" on f32 data is
3xTF32 on wgmma, f32-faithful to about 2^-22 a term; "high" the bf16x3
split and "default" one bf16 pass, on mma.sync; bf16 data one exact bf16
pass.  The plain version's "highest" is a full-f32 `bmm`; the two agree
within 1e-5 of max|C| (chip_smoke.py's gate).

The reference's VMEM budget (`_tier`) and its `nbc <= 4096` SMEM gate are
TPU memory limits and do not bound the kernel, which keeps no panel
resident: `supported` takes every b % 128 == 0.  They are kept in
`reference_rows_rule`, which the router uses only so that its aligned
decision is the reference's.  A CPU tensor takes `rows_spgemm_reference`;
a CUDA tensor launches the kernel or raises.  `rows_spgemm.launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
from hierarchical_block_sparse_lib_tpu_torch.kernels import _build
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
    _bucket,
    build_tables,
    check_blocks,
    expand_pairs,
    pair_slots,
    tier_bmm,
)

_DTYPES = (torch.float32, torch.bfloat16)


# The TPU kernels' VMEM budget, which the reference's row-panel and
# row-group rules use.
REFERENCE_VMEM_BUDGET = int(13.5 * 1024 * 1024)


def supported(b: int, dtype) -> bool:
    """Row-panel kernel applicability on the card: b a multiple of 128
    with f32 or bf16 data.  Unlike the reference, row caps and `nbc`
    bound nothing: the kernel keeps no panel resident."""
    return b % 128 == 0 and dtype in _DTYPES


def _reference_tier(b: int, itemsize: int, b_row_max: int, c_row_max: int):
    """The TPU kernel's pipeline tier (acc_parities, panel_parities) whose
    buffers fit its VMEM budget, or None."""
    bb, cb = _bucket(max(b_row_max, 1)), _bucket(max(c_row_max, 1))
    for acc_p, panel_p in ((2, 4), (2, 3), (2, 2), (1, 2), (1, 1)):
        vmem = (panel_p * bb * b * b * itemsize + acc_p * cb * b * b * 4
                + panel_p * b * b * itemsize)
        if vmem <= REFERENCE_VMEM_BUDGET:
            return acc_p, panel_p
    return None


def reference_rows_rule(b: int, dtype, b_row_max: int, c_row_max: int, nbc: int) -> bool:
    """The JAX package's `supported()` for its row-panel kernel, which its
    router uses to choose the aligned regime: b % 128 == 0, ``nbc <=
    4096``, not float64, and a VMEM pipeline tier that fits the row caps.
    A TPU memory rule, kept only so that `freeze_route_plan` decides as
    the reference does."""
    return (
        b % 128 == 0
        and nbc <= 4096
        and dtype != torch.float64
        and _reference_tier(b, dtype.itemsize, b_row_max, c_row_max) is not None
    )


def ring_tier(precision: str, dtype) -> str:
    """The tier the ring engine (the rows and groups kernels) runs
    `precision` at for `dtype` data; raise on an unknown precision."""
    if precision not in _build.PRECISION_CODES:
        raise ValueError(f"unknown precision {precision!r}")
    # bf16 storage: one pass is already operand-exact, as in the reference.
    return "highest" if dtype == torch.bfloat16 else precision


def _tau2(tau2):
    """tau2 as (device tensor [1] or None, host f32 value)."""
    if tau2 is None:
        return None, 0.0
    if isinstance(tau2, torch.Tensor) and tau2.device.type != "cpu":
        return tau2.to(torch.float32).reshape(1).contiguous(), 0.0
    return None, float(np.float32(float(tau2)))


# Pairs per batched product of the plain version: bounds its gathered
# operands and products to 1.5 GB at b = 128.
PLAIN_PAIR_CHUNK = 8192


def rows_spgemm_reference(
    a_ids, a_data, b_ids, b_data, out_ids, nbr: int, nbrB: int, nbc: int,
    out_cap: int, b_row_max: int, c_row_max: int, precision: str = "highest",
    a_norms2=None, b_norms2=None, tau2=None, triu: bool = False,
    acc_data=None,
) -> torch.Tensor:
    """The plain PyTorch version of `rows_spgemm` (same arguments), on any
    device: expand the pairs the row tables give, drop those the options
    skip, batched `torch.bmm`s at the requested tier (`PLAIN_PAIR_CHUNK`
    pairs each), and `index_add_`s into ``out_cap + 1`` slots whose last
    (pairs with no output slot) is dropped."""
    del c_row_max
    b = a_data.shape[-1]
    dev = a_data.device
    precision = ring_tier(precision, a_data.dtype)
    _, a_col, b_row_start, b_col, _, _ = build_tables(
        a_ids, b_ids, out_ids, nbr, nbrB, nbc
    )
    a_idx, b_idx = expand_pairs(a_ids, a_col, b_row_start, b_row_max)
    a_row = a_ids[a_idx].long() // nbrB
    col = b_col[b_idx].long()
    keep = torch.ones_like(a_idx, dtype=torch.bool)
    if a_norms2 is not None:
        t2_dev, t2 = _tau2(tau2)
        t2 = t2_dev[0] if t2_dev is not None else t2
        keep &= a_norms2.to(torch.float32)[a_idx] * b_norms2.to(torch.float32)[b_idx] > t2
    if triu:
        keep &= col >= a_row
    c_id = (a_row * nbc + col).to(torch.int32)
    out = torch.zeros((out_cap + 1, b, b), dtype=torch.float32, device=dev)
    valid_slot = out_ids != SENTINEL
    if acc_data is not None:
        out[:out_cap] = torch.where(valid_slot[:, None, None], acc_data.to(torch.float32), 0)
    if out_cap == 0 or a_idx.numel() == 0:
        return out[:out_cap]
    slot = torch.where(keep, pair_slots(out_ids, c_id, out_cap), out_cap)
    for p0 in range(0, a_idx.numel(), PLAIN_PAIR_CHUNK):
        p = slice(p0, p0 + PLAIN_PAIR_CHUNK)
        prod = tier_bmm(
            a_data[a_idx[p]].to(torch.float32), b_data[b_idx[p]].to(torch.float32), precision
        )
        out.index_add_(0, slot[p], prod)
    return out[:out_cap]


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entries of gemm_rows.cu and their arguments (pointers and the
# stream as c_void_p, ints as c_int, tau2_val as c_float).
SIGNATURES = {
    "hbsm_rows_spgemm": [_P] * 11 + [ctypes.c_float, _P] + [_I] * 8 + [_P],
    "hbsm_rows_spgemm_config": [_I, _I, _P],
}
CONFIG_KEYS = ("smem_bytes", "blocks_per_sm", "registers", "local_bytes", "threads")


def launch_config(dtype, precision: str) -> dict:
    """What a launch for this data type and tier gets, read from the
    library and the card: dynamic shared bytes, resident blocks per SM,
    registers and local (spill) bytes per thread, threads per block."""
    lib = _build.bind("gemm_rows", SIGNATURES)
    info = (ctypes.c_int * len(CONFIG_KEYS))()
    err = lib.hbsm_rows_spgemm_config(
        int(dtype == torch.bfloat16), _build.PRECISION_CODES[ring_tier(precision, dtype)],
        ctypes.cast(info, ctypes.c_void_p),
    )
    _build.check(lib, err, "rows_spgemm config")
    return dict(zip(CONFIG_KEYS, info))


def rows_spgemm(
    a_ids: torch.Tensor,  # int32[capA] sorted (SENTINEL padded)
    a_data: torch.Tensor,  # [capA, b, b] f32 or bf16
    b_ids: torch.Tensor,  # int32[capB] sorted
    b_data: torch.Tensor,  # [capB, b, b], A's type
    out_ids: torch.Tensor,  # int32[out_cap] sorted distinct output ids
    nbr: int,  # A block-rows
    nbrB: int,  # B block-rows (= A block-cols)
    nbc: int,  # B block-cols
    out_cap: int,
    b_row_max: int,
    c_row_max: int,
    precision: str = "highest",
    a_norms2: torch.Tensor | None = None,  # f32[capA]: SpAMM skip
    b_norms2: torch.Tensor | None = None,  # f32[capB]
    tau2=None,  # f32 squared threshold: a number or a 0-dim tensor
    triu: bool = False,  # compute only slots with col >= row
    acc_data: torch.Tensor | None = None,  # f32[out_cap, b, b] aligned accumulator
) -> torch.Tensor:
    """f32[out_cap, b, b]: block products accumulated into the slots of
    `out_ids`.  `c_row_max` is accepted for the reference's signature: a
    slot has its own thread block, so a C row has no cap (the caller
    still flags rows above it)."""
    device = a_data.device
    kw = dict(precision=precision, a_norms2=a_norms2, b_norms2=b_norms2,
              tau2=tau2, triu=triu, acc_data=acc_data)
    if device.type == "cpu":
        return rows_spgemm_reference(
            a_ids, a_data, b_ids, b_data, out_ids, nbr, nbrB, nbc, out_cap,
            b_row_max, c_row_max, **kw,
        )
    if device.type != "cuda":
        raise ValueError(f"rows_spgemm runs on CPU or CUDA tensors, got {device}")
    b = a_data.shape[-1]
    if not supported(b, a_data.dtype):
        raise ValueError(
            f"rows_spgemm kernel needs b % 128 == 0 with f32 or bf16 data, "
            f"got b={b} {a_data.dtype}"
        )
    if (a_norms2 is None) != (b_norms2 is None):
        raise ValueError("the SpAMM skip needs both a_norms2 and b_norms2")
    precision = ring_tier(precision, a_data.dtype)
    a_data, b_data = a_data.contiguous(), b_data.contiguous()
    cap_a, cap_b = a_data.shape[0], b_data.shape[0]
    check_blocks("a_data", a_data, (cap_a, b, b), a_data.dtype, device)
    check_blocks("b_data", b_data, (cap_b, b, b), a_data.dtype, device)
    a_row_start, a_col, b_row_start, b_col, _, _ = build_tables(
        a_ids, b_ids, out_ids, nbr, nbrB, nbc
    )
    for name, t, n in (
        ("a_ids", a_ids, cap_a), ("b_ids", b_ids, cap_b),
        ("out_ids", out_ids, out_cap), ("a_row_start", a_row_start, nbr + 1),
        ("a_col", a_col, cap_a), ("b_row_start", b_row_start, nbrB + 1),
        ("b_col", b_col, cap_b),
    ):
        _build.check_index(name, t, n, device)
    ptrs = {}
    if acc_data is not None:
        acc_data = acc_data.to(torch.float32).contiguous()
        check_blocks("acc_data", acc_data, (out_cap, b, b), torch.float32, device)
        ptrs["acc"] = acc_data.data_ptr()
    t2_dev, t2 = None, 0.0
    if a_norms2 is not None:
        a_norms2 = a_norms2.to(torch.float32).contiguous()
        b_norms2 = b_norms2.to(torch.float32).contiguous()
        for name, t, n in (("a_norms2", a_norms2, cap_a), ("b_norms2", b_norms2, cap_b)):
            if t.device != device or tuple(t.shape) != (n,):
                raise ValueError(f"{name}: need f32[{n}] on {device}")
        t2_dev, t2 = _tau2(tau2 if tau2 is not None else 0.0)
        if t2_dev is not None and t2_dev.device != device:
            raise ValueError(f"tau2 on {t2_dev.device}, operands on {device}")
    out = torch.empty((out_cap, b, b), dtype=torch.float32, device=device)
    _build.launch(
        _build.bind("gemm_rows", SIGNATURES), "hbsm_rows_spgemm", "rows_spgemm launch failed",
        device,
        out_ids.data_ptr(), a_row_start.data_ptr(), a_col.data_ptr(),
        b_row_start.data_ptr(), b_col.data_ptr(), a_data.data_ptr(),
        b_data.data_ptr(), ptrs.get("acc"),
        a_norms2.data_ptr() if a_norms2 is not None else None,
        b_norms2.data_ptr() if b_norms2 is not None else None,
        t2_dev.data_ptr() if t2_dev is not None else None, t2,
        out.data_ptr(), out_cap, nbr, nbc, _bucket(max(b_row_max, 1)),
        int(triu), b, int(a_data.dtype == torch.bfloat16),
        _build.PRECISION_CODES[precision],
    )
    rows_spgemm.launches += 1
    return out


rows_spgemm.launches = 0
