"""Host-side symbolic planning: the shared C++ engine in ``csrc/`` with a
numpy fallback.

This is the port's own ctypes loader for ``csrc/libhbsm_host.so`` (built
by ``make -C csrc`` at first use when a toolchain is present).  It does
not import the JAX package's ``runtime/native.py``, whose package
``__init__`` imports jax.  The numpy fallbacks are the JAX package's,
verbatim; `symbolic_spgemm` has none, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_SENTINEL = np.int32(np.iinfo(np.int32).max)

_LIB = None
_LIB_TRIED = False


def _csrc_dir() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "csrc")


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(_csrc_dir(), "libhbsm_host.so")
    if not os.path.exists(so) and os.environ.get("HBSM_NO_NATIVE_BUILD") != "1":
        try:  # one build attempt; the numpy fallback covers failure
            subprocess.run(
                ["make", "-C", _csrc_dir()],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            pass
    if not os.path.exists(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
    for fn in (lib.hbsm_plan_spgemm, lib.hbsm_plan_spgemm_ex):
        fn.restype = None
        fn.argtypes = [i32p, i64, i32p, i64, i32, i32, i32, i64p]
    lib.hbsm_plan_spamm.restype = None
    lib.hbsm_plan_spamm.argtypes = [
        i32p, f32p, i64, i32p, f32p, i64, i32, i32, i32, f64, i64p,
    ]
    lib.hbsm_symbolic_spgemm.restype = i64
    lib.hbsm_symbolic_spgemm.argtypes = [
        i32p, i64, i32p, i64, i32, i32, i64, i32p, i32p, i32p,
    ]
    lib.hbsm_plan_add.restype = i64
    lib.hbsm_plan_add.argtypes = [i32p, i64, i32p, i64]
    lib.hbsm_count_coo_blocks.restype = i64
    lib.hbsm_count_coo_blocks.argtypes = [i32p, i32p, i64, i32, i32]
    _LIB = lib
    return _LIB


def have_native() -> bool:
    return _load_lib() is not None


def _c32(a):
    return np.ascontiguousarray(np.asarray(a, np.int32))


def _ptr32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def plan_spgemm_numpy(a_ids, b_ids, a_nbc, b_nbr, b_nbc):
    """Exact (n_pairs, n_out_blocks) for C = A @ B, numpy host path."""
    del b_nbr
    a_ids = np.asarray(a_ids, np.int64)
    b_ids = np.asarray(b_ids, np.int64)
    a_ids = a_ids[a_ids != _SENTINEL]
    b_ids = b_ids[b_ids != _SENTINEL]
    a_row, a_col = a_ids // a_nbc, a_ids % a_nbc
    b_row, b_col = b_ids // b_nbc, b_ids % b_nbc
    lo = np.searchsorted(b_row, a_col, side="left")
    hi = np.searchsorted(b_row, a_col, side="right")
    cnt = hi - lo
    n_pairs = int(cnt.sum())
    out_ids = set()
    offs = np.concatenate([[0], np.cumsum(cnt)])
    CHUNK = 1 << 22
    for s in range(0, n_pairs, CHUNK):
        p = np.arange(s, min(s + CHUNK, n_pairs))
        e = np.searchsorted(offs, p, side="right") - 1
        t = p - offs[e]
        cid = a_row[e] * b_nbc + b_col[lo[e] + t]
        out_ids.update(np.unique(cid).tolist())
    return n_pairs, len(out_ids)


def plan_spgemm(a_ids, b_ids, a_nbc, b_nbr, b_nbc):
    """Exact (n_pairs, n_out_blocks); C++ fast path when available."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    if lib is not None:
        out = np.zeros(2, np.int64)
        lib.hbsm_plan_spgemm(
            _ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size,
            np.int32(a_nbc), np.int32(b_nbr), np.int32(b_nbc),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return int(out[0]), int(out[1])
    return plan_spgemm_numpy(a_ids, b_ids, a_nbc, b_nbr, b_nbc)


def plan_spgemm_ex_numpy(a_ids, b_ids, a_nbc, b_nbc):
    """(n_pairs, n_out, max_b_row, max_c_row) — numpy fallback."""
    a_ids = np.asarray(a_ids, np.int64)
    b_ids = np.asarray(b_ids, np.int64)
    a_ids = a_ids[a_ids != _SENTINEL]
    b_ids = b_ids[b_ids != _SENTINEL]
    a_row, a_col = a_ids // a_nbc, a_ids % a_nbc
    b_row, b_col = b_ids // b_nbc, b_ids % b_nbc
    max_b_row = int(np.bincount(b_row).max()) if b_ids.size else 0
    lo = np.searchsorted(b_row, a_col, side="left")
    hi = np.searchsorted(b_row, a_col, side="right")
    cnt = hi - lo
    n_pairs = int(cnt.sum())
    offs = np.concatenate([[0], np.cumsum(cnt)])
    out_ids = set()
    CHUNK = 1 << 22
    for s in range(0, n_pairs, CHUNK):
        p = np.arange(s, min(s + CHUNK, n_pairs))
        e = np.searchsorted(offs, p, side="right") - 1
        t = p - offs[e]
        cid = a_row[e] * b_nbc + b_col[lo[e] + t]
        out_ids.update(np.unique(cid).tolist())
    if out_ids:
        oid = np.fromiter(out_ids, np.int64)
        max_c_row = int(np.bincount(oid // b_nbc).max())
    else:
        max_c_row = 0
    return n_pairs, len(out_ids), max_b_row, max_c_row


def plan_spgemm_ex(a_ids, b_ids, a_nbc, b_nbr, b_nbc):
    """Exact (n_pairs, n_out, max_b_row, max_c_row); the row maxima are
    the fine kernel's row caps."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    if lib is not None:
        out = np.zeros(4, np.int64)
        lib.hbsm_plan_spgemm_ex(
            _ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size,
            np.int32(a_nbc), np.int32(b_nbr), np.int32(b_nbc),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return tuple(int(v) for v in out)
    return plan_spgemm_ex_numpy(a_ids, b_ids, a_nbc, b_nbc)


def _spamm_pairs(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc):
    """Chunks of the enumerated pairs of C = A @ B (SENTINEL padding
    dropped): yields (A entry e, B entry j, ||A_e|| * ||B_j||) arrays,
    norms in f64, and the valid ids and their block coordinates."""
    a_ids = np.asarray(a_ids, np.int64)
    b_ids = np.asarray(b_ids, np.int64)
    a_norms = np.asarray(a_norms, np.float64)
    b_norms = np.asarray(b_norms, np.float64)
    av = a_ids != _SENTINEL
    bv = b_ids != _SENTINEL
    a_ids, a_norms = a_ids[av], a_norms[av]
    b_ids, b_norms = b_ids[bv], b_norms[bv]
    b_row = b_ids // b_nbc
    lo = np.searchsorted(b_row, a_ids % a_nbc, side="left")
    hi = np.searchsorted(b_row, a_ids % a_nbc, side="right")
    cnt = hi - lo
    offs = np.concatenate([[0], np.cumsum(cnt)])
    n_all = int(cnt.sum())
    chunk = 1 << 22
    for s in range(0, n_all, chunk):
        p = np.arange(s, min(s + chunk, n_all))
        e = np.searchsorted(offs, p, side="right") - 1
        j = lo[e] + p - offs[e]
        yield e, j, a_norms[e] * b_norms[j], a_ids, b_ids


def plan_spamm_numpy(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc, tau):
    """Exact (n_pairs, n_out) of the norm-filtered multiply (pairs with
    ||A_ik|| * ||B_kj|| <= tau skipped), numpy host path."""
    n_pairs = 0
    out_ids = set()
    for e, j, prod, av, bv in _spamm_pairs(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc):
        keep = prod > tau
        n_pairs += int(keep.sum())
        cid = ((av[e] // a_nbc) * b_nbc + bv[j] % b_nbc)[keep]
        out_ids.update(np.unique(cid).tolist())
    return n_pairs, len(out_ids)


def spamm_error_bound(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc, tau):
    """Sum of ||A_ik|| * ||B_kj|| over the SKIPPED pairs: the a-priori
    Frobenius bound on ||C_exact - C_spamm|| for the given tau (triangle
    inequality over the dropped block products)."""
    total = 0.0
    for _, _, prod, _, _ in _spamm_pairs(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc):
        total += float(prod[prod <= tau].sum())
    return total


def plan_spamm(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbr, b_nbc, tau):
    """Exact (n_pairs, n_out) when products with ||A_ik|| * ||B_kj|| <= tau
    are skipped (SpAMM error control); C++ fast path when available."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    a_norms = np.ascontiguousarray(np.asarray(a_norms, np.float32))
    b_norms = np.ascontiguousarray(np.asarray(b_norms, np.float32))
    if lib is not None:
        f32p = ctypes.POINTER(ctypes.c_float)
        out = np.zeros(2, np.int64)
        lib.hbsm_plan_spamm(
            _ptr32(a_ids), a_norms.ctypes.data_as(f32p), a_ids.size,
            _ptr32(b_ids), b_norms.ctypes.data_as(f32p), b_ids.size,
            np.int32(a_nbc), np.int32(b_nbr), np.int32(b_nbc), float(tau),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return int(out[0]), int(out[1])
    return plan_spamm_numpy(a_ids, a_norms, b_ids, b_norms, a_nbc, b_nbc, tau)


def plan_add_numpy(a_ids, b_ids) -> int:
    """|union| of two id lists (SENTINEL padding ignored), numpy host path."""
    a = np.asarray(a_ids)
    b = np.asarray(b_ids)
    return int(np.union1d(a[a != _SENTINEL], b[b != _SENTINEL]).size)


def plan_add(a_ids, b_ids) -> int:
    """|union| of two sorted id lists: the exact capacity of `add`; C++
    fast path when available."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    if lib is not None:
        return int(lib.hbsm_plan_add(_ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size))
    return plan_add_numpy(a_ids, b_ids)


def count_coo_blocks_numpy(rows, cols, block_size: int, nb_cols: int) -> int:
    """Distinct blocks touched by COO triplets, numpy host path."""
    bid = (np.asarray(rows) // block_size).astype(np.int64) * nb_cols + (
        np.asarray(cols) // block_size
    )
    return int(np.unique(bid).size)


def count_coo_blocks(rows, cols, block_size: int, nb_cols: int) -> int:
    """Distinct blocks touched by COO triplets: the exact `from_coo`
    capacity; C++ fast path when available."""
    lib = _load_lib()
    rows = _c32(rows)
    cols = _c32(cols)
    if lib is not None:
        return int(lib.hbsm_count_coo_blocks(
            _ptr32(rows), _ptr32(cols), rows.size,
            np.int32(block_size), np.int32(nb_cols),
        ))
    return count_coo_blocks_numpy(rows, cols, block_size, nb_cols)


def symbolic_spgemm(a_ids, b_ids, a_nbc, b_nbc, pair_cap: int):
    """Host-side full symbolic phase: (a_idx, b_idx, c_id, total) with the
    first min(total, pair_cap) entries filled, sorted by c_id.  Unfilled
    tail is SENTINEL.  C++ only (numpy callers use spgemm_symbolic on
    the device instead)."""
    lib = _load_lib()
    a_ids = _c32(a_ids)
    b_ids = _c32(b_ids)
    a_idx = np.full(pair_cap, 0, np.int32)
    b_idx = np.full(pair_cap, 0, np.int32)
    c_id = np.full(pair_cap, _SENTINEL, np.int32)
    if lib is None:
        raise RuntimeError("native library unavailable; build csrc first")
    total = lib.hbsm_symbolic_spgemm(
        _ptr32(a_ids), a_ids.size, _ptr32(b_ids), b_ids.size,
        np.int32(a_nbc), np.int32(b_nbc), np.int64(pair_cap),
        _ptr32(a_idx), _ptr32(b_idx), _ptr32(c_id),
    )
    return a_idx, b_idx, c_id, int(total)
