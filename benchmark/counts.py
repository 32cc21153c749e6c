"""Work of a call, counted from its inputs by the benchmark itself (never
from the program's counters): block masks, leaf-block pairs, the
product's support, FLOPs and bytes.

A product C = A @ B of block-sparse matrices does one leaf GEMM for every
pair (A_ik, B_kj) of stored blocks, so its pairs are
``sum_k (stored blocks in column k of A) * (stored blocks in row k of B)``
and its FLOPs ``2 * b^3 * pairs``.  Its least traffic reads each stored
input block once and writes each output block once.
"""

from __future__ import annotations

import numpy as np


def block_mask(ids, nb: int) -> np.ndarray:
    """bool [nb, nb]: the stored blocks of a square block grid."""
    m = np.zeros(nb * nb, dtype=bool)
    m[np.asarray(ids, dtype=np.int64)] = True
    return m.reshape(nb, nb)


def pairs(mask_a: np.ndarray, mask_b: np.ndarray) -> int:
    """Leaf-block pairs of A @ B."""
    return int(np.dot(mask_a.sum(0, dtype=np.int64), mask_b.sum(1, dtype=np.int64)))


def product_mask(mask_a: np.ndarray, mask_b: np.ndarray) -> np.ndarray:
    """bool [nb, nb]: the blocks of A @ B that at least one pair reaches."""
    return (mask_a.astype(np.float64) @ mask_b.astype(np.float64)) > 0


def mask_ids(mask: np.ndarray) -> np.ndarray:
    """Sorted int64 row-major ids of a block mask."""
    return np.flatnonzero(mask.reshape(-1)).astype(np.int64)


def gemm_flops(n_pairs: int, b: int) -> int:
    return 2 * b**3 * int(n_pairs)


def block_bytes(n_blocks: int, b: int, itemsize: int = 4) -> int:
    return int(n_blocks) * b * b * itemsize


def least_seconds(flops: float, nbytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the card needs: the larger of FLOPs over the peak
    rate and bytes over the memory rate."""
    return max(flops / peak_flops, nbytes / peak_bytes)
