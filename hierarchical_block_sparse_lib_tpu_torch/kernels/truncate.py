"""Leaf truncation in two passes on the card: the wrapper of the Hopper
kernels ``kernels/csrc/truncate.cu``.

`truncate_kernel(ids, data, out_cap, tau2=..., keep=...)` gives (out_ids
int32[out_cap], out_data [out_cap, ...], nnz int32[], kept int32[]): the
blocks of the sorted, SENTINEL-padded `ids` whose squared Frobenius norm
exceeds `tau2` (or, given a mask, those `keep` marks), valid ids only,
moved in slot order to the front of `out_cap` slots, the highest dropped
past it; SENTINEL ids and zero blocks after them; `nnz` the survivors
clamped to `out_cap` and `kept` the survivors before the clamp.  Two
launches a call: the norm pass (or, with `keep`, a count of it by tiles)
and the compaction.  The blocks move as raw words, so given one keep mask
the result has the bits of ``ops/truncate.py::compact_reference``, the
former stable compaction.

Replaces no TPU kernel: the JAX package truncates in jnp, see the source's
note.  The plain version is ``ops/truncate.py::truncate_reference``, which
CPU tensors take; this module runs on CUDA tensors of f32, bf16 or f64
blocks whose bytes are a multiple of 16, and raises on anything else.
`truncate_kernel.launches` counts the passes launched.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import _build

# Slots a tile of the passes takes at least (the kernels' block of threads),
# and the most tiles a call has: each block of the compaction sums the
# counts of all of them.
TILE = 256
MAX_TILES = 1024

_P, _I, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
# The C entries of truncate.cu and their arguments.
SIGNATURES = {
    "hbsm_truncate_norms": [_P, _P, _I, _L, _I, _I, _P, _D, _P, _P, _P, _P],
    "hbsm_truncate_count": [_P, _P, _I, _I, _P, _P],
    "hbsm_truncate_compact": [_P, _P, _P, _I, _L, _I, _P, _I, _P, _P, _P, _P],
}


def tile_slots(cap: int) -> int:
    """Slots a tile takes at capacity `cap`: 256, or the multiple of 256 that
    keeps the tiles at most `MAX_TILES`."""
    return TILE * max(1, -(-cap // (TILE * MAX_TILES)))


def _check(ids, data):
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"truncate kernels run on CUDA tensors, got {dev}")
    if data.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"truncate kernels take f32, bf16 or f64 blocks, got {data.dtype}")
    block_bytes = math.prod(data.shape[1:]) * data.element_size()
    if block_bytes % 16:
        raise ValueError(f"truncate kernels need blocks of a multiple of 16 bytes, got "
                         f"{tuple(data.shape)} {data.dtype}")
    ids = ids.to(torch.int32).contiguous()
    _build.check_index("ids", ids, data.shape[0], dev)
    return ids, _build.aligned16(data), block_bytes // 16


def _norms(ids, data, n_words, tau2, tile, n2):
    """Pass 1: (keep bool[cap], tile counts int32[tiles]), and the squared
    norms into `n2` when it is given."""
    dev, cap = data.device, data.shape[0]
    tdt = torch.promote_types(data.dtype, torch.float32)
    tau2_dev, tau2_val = None, 0.0
    if isinstance(tau2, torch.Tensor) and tau2.device.type != "cpu":
        if tau2.device != dev:
            raise ValueError(f"tau^2 on {tau2.device}, blocks on {dev}")
        tau2_dev = tau2.to(tdt).reshape(1).contiguous()
    else:
        tau2_val = float(tau2)
    keep = torch.empty((cap,), dtype=torch.bool, device=dev)
    counts = torch.empty((-(-cap // tile),), dtype=torch.int32, device=dev)
    _build.launch(
        _build.bind("truncate", SIGNATURES), "hbsm_truncate_norms",
        "truncate norm pass launch failed", dev,
        ids.data_ptr(), data.data_ptr(), cap, n_words, _build.DTYPE_CODES[data.dtype], tile,
        tau2_dev.data_ptr() if tau2_dev is not None else None, tau2_val,
        n2.data_ptr() if n2 is not None else None, keep.data_ptr(), counts.data_ptr(),
    )
    return keep, counts


def block_norms_keep(ids, data, tau2):
    """The norm pass alone: (n2 [cap] of promote_types(dtype, f32), keep
    bool[cap]) with keep = id != SENTINEL and n2 > `tau2` (a number, or a
    0-dim tensor on the card read there).  One counted launch."""
    ids, data, n_words = _check(ids, data)
    tdt = torch.promote_types(data.dtype, torch.float32)
    n2 = torch.empty((data.shape[0],), dtype=tdt, device=data.device)
    keep, _ = _norms(ids, data, n_words, tau2, tile_slots(data.shape[0]), n2)
    truncate_kernel.launches += 1
    return n2, keep


def truncate_kernel(ids, data, out_cap: int, tau2=None, keep=None):
    """(out_ids, out_data, nnz, kept) of the blocks kept by norm (squared
    norm above `tau2`, a number or a 0-dim tensor on the card read there,
    with no host sync) or, given `keep` (bool[cap] on the card), of those it
    marks; SENTINEL slots are never kept."""
    ids, data, n_words = _check(ids, data)
    dev, cap = data.device, data.shape[0]
    tile = tile_slots(cap)
    lib = _build.bind("truncate", SIGNATURES)
    if keep is None:
        keep, counts = _norms(ids, data, n_words, tau2, tile, None)
    else:
        if keep.dtype != torch.bool or keep.shape != (cap,) or keep.device != dev:
            raise ValueError(f"keep: need bool[{cap}] on {dev}")
        keep = keep.contiguous()
        counts = torch.empty((-(-cap // tile),), dtype=torch.int32, device=dev)
        _build.launch(lib, "hbsm_truncate_count", "truncate count pass launch failed", dev,
                      ids.data_ptr(), keep.data_ptr(), cap, tile, counts.data_ptr())
    out_ids = torch.empty((out_cap,), dtype=torch.int32, device=dev)
    out_data = torch.empty((out_cap,) + tuple(data.shape[1:]), dtype=data.dtype, device=dev)
    nnz_kept = torch.empty((2,), dtype=torch.int32, device=dev)
    _build.launch(
        lib, "hbsm_truncate_compact", "truncate compaction launch failed", dev,
        ids.data_ptr(), data.data_ptr(), keep.data_ptr(), cap, n_words, tile, counts.data_ptr(),
        out_cap, out_ids.data_ptr(), out_data.data_ptr(), nnz_kept.data_ptr(),
    )
    truncate_kernel.launches += 2
    return out_ids, out_data, nnz_kept[0], nnz_kept[1]


truncate_kernel.launches = 0
