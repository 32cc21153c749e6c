"""Fine-leaf (b in {16, 32, 64}) row-panel SpGEMM: the wrapper of the
Hopper kernel ``kernels/csrc/gemm_fine.cu`` and its plain PyTorch version.

Replaces ``hierarchical_block_sparse_lib_tpu/kernels/pallas_gemm_fine.py::
fine_spgemm`` and keeps its contract: products C(i,j) = sum_k
alpha*A(i,k) B(k,j) land in the slots of `out_ids` (sorted, distinct
product ids), slots past the last used one are zero, B rows are seen up
to the bucketed row cap `b_row_max`, and `alpha` is folded into A before
any rounding.  Payloads come in and go out either canonical
``[cap, b, b]`` or transposed-flat ``[cap, b*b/128, 128]`` (each block
stored as ``flat(block^T)``, ops/fine.py).  The kernel works on the
transposed blocks: it reads A^T and B^T and writes C^T = B^T (alpha A)^T,
which is the flat layout's memory as it is.  One thread block takes a
chunk of a C block-row's slots (`slot_chunks`, at most `CHUNK_SLOTS`),
so the row's A blocks are staged once for all of them.  See the kernel
source for what bounds it on the card and what its design does about
that.

A CPU tensor takes `fine_spgemm_reference`; a CUDA tensor launches the
kernel or raises.  `fine_spgemm.launches` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
from hierarchical_block_sparse_lib_tpu_torch.kernels import _build
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span

_G8 = 8  # row-cap bucket, as the reference's
# Output slots per thread block of the kernel (a chunk of one C row), and
# the resident blocks per SM its shared memory is sized for where not one
# (scripts/time_fine_kernel.py measures both).
CHUNK_SLOTS = 128
CTAS_PER_SM = {(16, "high"): 2}
# B payload bytes per column window of the kernel's schedule (L2: 50 MB),
# and the widest window: the kernel marks each A entry's B row as a bitmap
# of the columns a chunk spans (kSpan in gemm_fine.cu).
B_PANEL_BYTES = 16 << 20
SPAN = 256


def _bucket(n: int) -> int:
    return max(-(-n // _G8) * _G8, _G8)


def supported(b: int, dtype) -> bool:
    """Fine-leaf kernel applicability: b in {16, 32, 64}, f32 data.  The
    reference's `nbc <= 4096` and VMEM gates are TPU memory limits and
    do not apply here."""
    return b in (16, 32, 64) and dtype == torch.float32


def build_tables(a_ids, b_ids, out_ids, nbr: int, nbrB: int, nbc: int):
    """The row tables of the kernel, pure functions of the id structure:
    (a_row_start, a_col, b_row_start, b_col, c_row_start, ccol), int32.
    A's row is ``a_id // nbrB``: A's block-column count is B's block-row
    count.  Precompute them once per structure (ops.fine.make_fine_plan)."""

    def row_table(ids, n_rows: int, n_cols: int):
        sent = ids == SENTINEL
        rowv = torch.where(sent, n_rows, ids // n_cols).to(torch.int32)
        start = torch.searchsorted(
            rowv,
            torch.arange(n_rows + 1, dtype=torch.int32, device=ids.device),
            right=False, out_int32=True,
        )
        col = torch.where(sent, 0, ids % n_cols).to(torch.int32)
        return start, col

    a_row_start, a_col = row_table(a_ids, nbr, nbrB)
    b_row_start, b_col = row_table(b_ids, nbrB, nbc)
    c_row_start, ccol = row_table(out_ids, nbr, nbc)
    return (a_row_start, a_col, b_row_start, b_col, c_row_start, ccol)


def col_window(nbc: int, cap_b: int, b: int) -> int:
    """Block columns per window of `slot_chunks`: the fewest windows that
    keep each window's share of B's f32 payload (capacity, not nnz: no host
    read) under `B_PANEL_BYTES`, so the B blocks that one window's products
    read stay in L2 while every C row passes over it."""
    n_win = max(1, -(-cap_b * b * b * 4 // B_PANEL_BYTES))
    return -(-nbc // n_win)


def slot_chunks(out_ids, c_row_start, nbc: int, chunk_slots: int = CHUNK_SLOTS,
                window: int | None = None):
    """The kernel's work units: int32 ``[2, n]``, thread block c taking
    slots ``[chunks[0, c], chunks[1, c])``.  The output columns are cut
    into windows of `window` block columns (all of them by default), at
    most `SPAN`; each C row's slots in a window are cut into chunks of at
    most `chunk_slots`, so a chunk stays in one row and spans fewer than
    `SPAN` columns.  Chunks run window by
    window, rows ascending in each, then the SENTINEL tail's.  ``n =
    nbr * n_windows + 1 + ceil(out_cap / chunk_slots)`` bounds the count
    for any structure; the unused chunks at the end are empty.  Built on
    the ids' device with no host read."""
    dev = out_ids.device
    out_cap = out_ids.shape[0]
    nbr = c_row_start.shape[0] - 1
    window = min(nbc if window is None else window, SPAN)
    n_win = -(-nbc // window)
    # Each (window, row) piece's first slot: the first id at or past its
    # first column; the tail's from the first SENTINEL.
    first_col = torch.clamp(torch.arange(n_win + 1, device=dev) * window, max=nbc)
    keys = torch.arange(nbr, device=dev)[None, :] * nbc + first_col[:, None]
    edges = torch.searchsorted(out_ids, keys.to(torch.int32).contiguous()).long()
    tail = c_row_start[nbr:].long()
    starts = torch.cat([edges[:-1].flatten(), tail])
    ends = torch.cat([edges[1:].flatten(), torch.full_like(tail, out_cap)])
    pieces = (ends - starts + chunk_slots - 1) // chunk_slots
    last = torch.cumsum(pieces, 0)  # one past each piece's last chunk
    cap = nbr * n_win + 1 + -(-out_cap // chunk_slots)
    c = torch.arange(cap, device=dev)
    k = torch.searchsorted(last, c, right=True)
    kc = k.clamp(max=starts.shape[0] - 1)
    lo = starts[kc] + (c - (last[kc] - pieces[kc])) * chunk_slots
    hi = torch.minimum(lo + chunk_slots, ends[kc])
    used = k < starts.shape[0]
    return torch.stack([torch.where(used, lo, 0), torch.where(used, hi, 0)]).to(torch.int32)


def fine_tables(a_ids, b_ids, out_ids, nbr: int, nbrB: int, nbc: int, b: int):
    """`build_tables` plus the kernel's `slot_chunks` (windows sized by
    `col_window` for leaf b): the seven tables of one structure, made once
    per plan (ops.fine.make_fine_plan)."""
    with span("hbsm.symbolic"):
        tables = build_tables(a_ids, b_ids, out_ids, nbr, nbrB, nbc)
        window = col_window(nbc, b_ids.shape[0], b)
        return tables + (slot_chunks(out_ids, tables[4], nbc, window=window),)


def _operands(a_data, b_data, block_size, precision, alpha):
    """Resolve the leaf size, layout and precision tier, and make the
    kernel's operands: (b, flat_in, precision, at, bt) with `at` the
    alpha-scaled A^T blocks and `bt` the B^T blocks, ``[cap, b, b]``,
    bf16 at "default" and f32 otherwise."""
    b = a_data.shape[-1] if block_size is None else block_size
    if b not in (16, 32, 64):
        raise ValueError(f"fine kernel needs b in (16,32,64), got {b}")
    if precision not in _build.PRECISION_CODES:
        raise ValueError(f"unknown precision {precision!r}")
    fr = (b * b) // 128
    flat_in = tuple(a_data.shape[1:]) == (fr, 128)
    if flat_in:
        if tuple(b_data.shape[1:]) != (fr, 128):
            raise ValueError("mixed A/B payload layouts")
    elif tuple(a_data.shape[1:]) != (b, b) or tuple(b_data.shape[1:]) != (b, b):
        raise ValueError(f"bad payload shapes {a_data.shape} {b_data.shape}")
    if precision == "high" and a_data.dtype != torch.float32:
        precision = "default"
    f32 = torch.float32
    st_dtype = torch.bfloat16 if precision == "default" else f32
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.to(f32)
    if flat_in:
        at_log = a_data.reshape(-1, b, b).to(f32)
        bt = b_data.reshape(-1, b, b)
    else:
        at_log = a_data.to(f32).transpose(-1, -2)
        bt = b_data.transpose(-1, -2)
    at = (at_log * alpha).to(st_dtype).contiguous()
    bt = bt.to(f32).to(st_dtype).contiguous()
    return b, flat_in, precision, at, bt


def _output(ct: torch.Tensor, b: int, out_layout: str) -> torch.Tensor:
    """C^T blocks ``[out_cap, b, b]`` -> the requested output layout."""
    if out_layout == "flat":
        return ct.reshape(ct.shape[0], (b * b) // 128, 128)
    if out_layout != "canonical":
        raise ValueError(f"unknown out_layout {out_layout!r}")
    return ct.transpose(-1, -2).contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C entries of gemm_fine.cu and their arguments.
SIGNATURES = {
    "hbsm_fine_spgemm": [_P, _I] + [_P] * 9 + [_I] * 5 + [_P],
    "hbsm_fine_spgemm_config": [_I] * 4 + [_P],
}


def check_blocks(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    """Raise unless `t` is a contiguous, 16-byte aligned [cap, b, b] block
    tensor of `dtype` on `device` (what the 128-tile GEMM kernels read)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, operands on {device}")
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype}{tuple(t.shape)}, expected {dtype}{shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: need contiguous 16-byte aligned blocks")


def fine_spgemm(
    a_ids: torch.Tensor,  # int32[capA] sorted (SENTINEL padded)
    a_data: torch.Tensor,  # [capA, b, b] canonical or [capA, b*b/128, 128] flat
    b_ids: torch.Tensor,  # int32[capB] sorted
    b_data: torch.Tensor,  # [capB, b, b] or flat
    out_ids: torch.Tensor,  # int32[out_cap] sorted distinct output ids
    nbr: int,
    nbrB: int,
    nbc: int,
    out_cap: int,
    b_row_max: int,
    c_row_max: int,
    precision: str = "highest",
    block_size: int | None = None,
    out_layout: str = "canonical",
    alpha=1.0,
    tables: tuple | None = None,
) -> torch.Tensor:
    """Products accumulated into `out_ids` slots, `alpha`-scaled.

    `c_row_max` is accepted for the reference's signature: the kernel
    cuts each C row into chunks of slots, one thread block each, and keeps
    every slot's sums in registers, so a C row needs no buffer and has no
    cap (the caller still flags rows above it).  `tables` is
    `fine_tables(...)` of these ids (a plan's), else built here.
    """
    device = a_data.device
    if device.type == "cpu":
        return fine_spgemm_reference(
            a_ids, a_data, b_ids, b_data, out_ids, nbr, nbrB, nbc, out_cap,
            b_row_max, c_row_max, precision=precision, block_size=block_size,
            out_layout=out_layout, alpha=alpha, tables=tables,
        )
    if device.type != "cuda":
        raise ValueError(f"fine_spgemm runs on CPU or CUDA tensors, got {device}")
    if b_data.device != device:
        raise ValueError(f"A on {device}, B on {b_data.device}")
    b = a_data.shape[-1] if block_size is None else block_size
    if tables is None:
        tables = fine_tables(a_ids, b_ids, out_ids, nbr, nbrB, nbc, b)
    if len(tables) != 7:
        raise ValueError("fine_spgemm on the card needs fine_tables(...)")
    a_row_start, a_col, b_row_start, b_col, c_row_start, ccol, chunks = tables
    cap_a, cap_b = a_data.shape[0], b_data.shape[0]
    for name, t, n in (
        ("a_ids", a_ids, cap_a), ("b_ids", b_ids, cap_b),
        ("out_ids", out_ids, out_cap), ("a_row_start", a_row_start, nbr + 1),
        ("a_col", a_col, cap_a), ("b_row_start", b_row_start, nbrB + 1),
        ("b_col", b_col, cap_b), ("c_row_start", c_row_start, nbr + 1),
        ("ccol", ccol, out_cap),
    ):
        _build.check_index(name, t, n, device)
    if chunks.dtype != torch.int32 or chunks.dim() != 2 or chunks.shape[0] != 2 \
            or not chunks.is_contiguous() or chunks.device != device:
        raise ValueError("chunks: need slot_chunks' contiguous int32 [2, n] table")
    b, _, precision, at, bt = _operands(a_data, b_data, block_size, precision, alpha)
    out = launch(out_ids, tables, at, bt, out_cap, nbr, nbc, b_row_max, precision)
    return _output(out, b, out_layout)


fine_spgemm.launches = 0


def launch(out_ids, tables, at, bt, out_cap: int, nbr: int, nbc: int,
           b_row_max: int, precision: str, ctas_per_sm: int | None = None) -> torch.Tensor:
    """The kernel alone, on CUDA operands made by `_operands` (`at`, `bt`,
    with `precision` as it resolved) and the tables of `fine_tables`: the
    C^T blocks ``[out_cap, b, b]`` f32.  `ctas_per_sm` sizes the launch's
    shared memory (default `ctas_per_sm(b, precision)`).  Counts in
    `fine_spgemm.launches`."""
    del nbr
    a_row_start, a_col, b_row_start, b_col, _, ccol, chunks = tables
    b = at.shape[-1]
    ctas = ctas_per_sm or CTAS_PER_SM.get((b, precision), 1)
    if at.data_ptr() % 16 or bt.data_ptr() % 16:
        raise ValueError("fine_spgemm needs 16-byte aligned payloads")
    device = at.device
    out = torch.empty((out_cap, b, b), dtype=torch.float32, device=device)
    _build.launch(
        _build.bind("gemm_fine", SIGNATURES), "hbsm_fine_spgemm", "fine_spgemm launch failed",
        device,
        chunks.data_ptr(), chunks.shape[1], out_ids.data_ptr(), ccol.data_ptr(),
        a_row_start.data_ptr(), a_col.data_ptr(), b_row_start.data_ptr(),
        b_col.data_ptr(), at.data_ptr(), bt.data_ptr(), out.data_ptr(), nbc,
        _bucket(max(b_row_max, 1)), b, _build.PRECISION_CODES[precision], ctas,
    )
    fine_spgemm.launches += 1
    return out


def launch_config(b: int, precision: str, b_row_max: int,
                  ctas_per_sm: int | None = None) -> dict:
    """What `launch` would run, read from the library and the card: the A
    entries staged per k-chunk, dynamic shared bytes, resident blocks per
    SM, registers and local (spill) bytes per thread, threads per block."""
    lib = _build.bind("gemm_fine", SIGNATURES)
    info = (ctypes.c_int * 6)()
    err = lib.hbsm_fine_spgemm_config(
        b, _build.PRECISION_CODES[precision], _bucket(max(b_row_max, 1)),
        ctas_per_sm or CTAS_PER_SM.get((b, precision), 1), ctypes.cast(info, ctypes.c_void_p),
    )
    _build.check(lib, err, "fine_spgemm config")
    keys = ("kc", "smem_bytes", "blocks_per_sm", "registers", "local_bytes", "threads")
    return dict(zip(keys, info))


@contextlib.contextmanager
def _ieee_fp32_matmul(device: torch.device):
    """cuBLAS may run f32 products in TF32 when the global flag allows it;
    the reference's "highest" and "high" tiers need full f32 products, so
    TF32 is switched off for the duration (CPU products are always f32)."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _split_bf16(x: torch.Tensor):
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def expand_pairs(a_ids, a_col, b_row_start, b_row_max: int):
    """The plain versions' pair list: A entry e (row i, column k) meets the
    first min(count, bucket(b_row_max)) blocks of B's row k, as the
    kernels see them.  Returns (a_idx, b_idx), int64; sizing it reads the
    device."""
    dev = a_ids.device
    k = a_col.long()
    lo = b_row_start[k].long()
    cnt = torch.clamp(b_row_start[k + 1].long() - lo, max=_bucket(max(b_row_max, 1)))
    cnt = torch.where(a_ids != SENTINEL, cnt, 0)
    a_idx = torch.repeat_interleave(torch.arange(a_ids.shape[0], device=dev), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    b_idx = lo[a_idx] + torch.arange(a_idx.shape[0], device=dev) - start[a_idx]
    return a_idx, b_idx


def pair_slots(out_ids, c_id, out_cap: int):
    """Slot of each pair's output id in the sorted `out_ids`; `out_cap`
    (a trash slot) where the id has none."""
    slot = torch.searchsorted(out_ids, c_id).clamp_(max=out_cap - 1)
    return torch.where(out_ids[slot] == c_id, slot, out_cap)


def tier_bmm(x: torch.Tensor, y: torch.Tensor, precision: str) -> torch.Tensor:
    """Batched f32 products x @ y at a precision tier: "high" as the bf16x3
    split, "default" of bf16-rounded operands (exact in f32), "highest"
    in full f32; TF32 off throughout."""
    with _ieee_fp32_matmul(x.device):
        if precision == "high":
            xh, xl = _split_bf16(x)
            yh, yl = _split_bf16(y)
            return torch.bmm(xh, yh) + (torch.bmm(xh, yl) + torch.bmm(xl, yh))
        if precision == "default":
            x = x.to(torch.bfloat16).to(torch.float32)
            y = y.to(torch.bfloat16).to(torch.float32)
        return torch.bmm(x, y)


def fine_spgemm_reference(
    a_ids, a_data, b_ids, b_data, out_ids, nbr: int, nbrB: int, nbc: int,
    out_cap: int, b_row_max: int, c_row_max: int, precision: str = "highest",
    block_size: int | None = None, out_layout: str = "canonical",
    alpha=1.0, tables: tuple | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of `fine_spgemm` (same arguments), on any
    device: expand the block pairs the kernel's tables give, gather them,
    one batched `torch.bmm` at the requested tier, then an `index_add_`
    into ``out_cap + 1`` slots whose last (products with no output slot)
    is dropped."""
    del c_row_max
    if tables is None:
        tables = build_tables(a_ids, b_ids, out_ids, nbr, nbrB, nbc)
    a_col, b_row_start, b_col = tables[1:4]
    b, _, precision, at, bt = _operands(a_data, b_data, block_size, precision, alpha)
    dev = a_data.device
    if out_cap == 0:
        return _output(torch.zeros((0, b, b), device=dev), b, out_layout)
    a_idx, b_idx = expand_pairs(a_ids, a_col, b_row_start, b_row_max)
    c_id = ((a_ids[a_idx].long() // nbrB) * nbc + b_col[b_idx].long()).to(torch.int32)
    slot = pair_slots(out_ids, c_id, out_cap)
    prod = tier_bmm(bt[b_idx].to(torch.float32), at[a_idx].to(torch.float32), precision)
    ct = torch.zeros((out_cap + 1, b, b), dtype=torch.float32, device=dev)
    ct.index_add_(0, slot, prod)
    return _output(ct[:out_cap], b, out_layout)
