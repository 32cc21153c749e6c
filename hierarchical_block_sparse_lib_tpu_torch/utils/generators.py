"""Test/benchmark matrix generators (port of ``utils/generators.py`` plus
the B2 generator of ``bench.py``).  Host-side numpy with the same RNG
call order as the JAX package, so the two packages build bit-identical
inputs from one seed."""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    BlockMatrix,
    resolve_device,
)


def banded_coo(n: int, bandwidth: int, seed: int = 0, dtype=np.float32):
    """Dense band: all entries with |i-j| <= bandwidth (BASELINE.json:7)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for d in range(-bandwidth, bandwidth + 1):
        i = np.arange(max(0, -d), min(n, n - d))
        rows.append(i)
        cols.append(i + d)
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(dtype)
    return rows, cols, vals


def random_block_sparse_coo(
    n: int,
    block_size: int,
    block_density: float,
    seed: int = 0,
    dtype=np.float32,
):
    """Uniformly random nonzero blocks, each filled dense
    (BASELINE.json:8: 5% block density)."""
    rng = np.random.default_rng(seed)
    nb = -(-n // block_size)
    n_blocks = max(1, int(round(block_density * nb * nb)))
    chosen = rng.choice(nb * nb, size=n_blocks, replace=False)
    brow, bcol = chosen // nb, chosen % nb
    b = block_size
    r_in = np.arange(b)
    rows = (brow[:, None, None] * b + r_in[None, :, None] + 0 * r_in).reshape(-1)
    cols = (bcol[:, None, None] * b + 0 * r_in[None, :, None] + r_in).reshape(-1)
    mask = (rows < n) & (cols < n)
    rows, cols = rows[mask].astype(np.int32), cols[mask].astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(dtype)
    return rows, cols, vals


def dense_oracle(rows, cols, vals, n_rows: int, n_cols: int | None = None):
    n_cols = n_rows if n_cols is None else n_cols
    d = np.zeros((n_rows, n_cols), dtype=np.asarray(vals).dtype)
    np.add.at(d, (rows, cols), vals)
    return d


def block_ids_banded(n: int, bandwidth: int, block_size: int):
    """Exact stored-block count for a banded matrix (for sizing caps)."""
    nb = -(-n // block_size)
    ids = set()
    for br in range(nb):
        lo_col = max(0, br * block_size - bandwidth)
        hi_col = min(n - 1, (br + 1) * block_size - 1 + bandwidth)
        for bc in range(lo_col // block_size, hi_col // block_size + 1):
            ids.add(br * nb + bc)
    return len(ids)


def random_block_matrix(
    n: int, b: int, density: float, seed: int = 0, dtype=np.float32,
    device=None,
) -> BlockMatrix:
    """Random block-sparse n x n matrix, every stored block dense N(0,1),
    on the card unless `device` names another: the configured B2 input
    is ``random_block_matrix(16384, 32, 0.05, seed=2)``
    (``bench.py::random_block_matrix``, same RNG calls)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    nb = n // b
    n_blocks = max(1, int(round(density * nb * nb)))
    chosen = np.sort(rng.choice(nb * nb, n_blocks, replace=False)).astype(np.int32)
    data = rng.standard_normal((n_blocks, b, b)).astype(dtype)
    return BlockMatrix(
        ids=torch.from_numpy(chosen).to(device),
        data=torch.from_numpy(data).to(device),
        nnz=torch.tensor(n_blocks, dtype=torch.int32, device=device),
        n_rows=n,
        n_cols=n,
        block_size=b,
    )


def banded_block_matrix(n: int, bw: int, b: int, seed: int = 0, device=None) -> BlockMatrix:
    """Dense band of half-width `bw`, assembled at leaf 16 and coarsened to
    leaf `b` at the tight capacity (``bench.py::banded_block_matrix``, the
    B3 input at ``(4096, 256, 128)``), on the card unless `device` names
    another."""
    from hierarchical_block_sparse_lib_tpu_torch.core.assembly import from_coo
    from hierarchical_block_sparse_lib_tpu_torch.ops.repack import (
        coarsen,
        plan_coarsen,
    )

    r, c, v = banded_coo(n, bw, seed=seed)
    base = 16 if b % 16 == 0 and b > 16 else b
    m = from_coo(r, c, v, n, block_size=base, device=device)
    if base != b:
        m = coarsen(m, b // base, cap=plan_coarsen(m, b // base))
    return m


def b5_mix(nb: int, b: int, band_halfwidth_blocks: int = 1, random_density: float = 0.002,
           seed: int = 7, device=None) -> BlockMatrix:
    """The B5 structure (BASELINE.json config 5, 131072^2 at nb = 1024, b =
    128): a block band plus a uniform random sprinkle of blocks, every
    stored block N(0, 1) / b, on the card unless `device` names another
    (``scripts/b5_route_evidence.py::b5_mix``, same RNG calls)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = np.arange(nb, dtype=np.int64)
    band = []
    for d in range(-band_halfwidth_blocks, band_halfwidth_blocks + 1):
        cc = rows + d
        ok = (cc >= 0) & (cc < nb)
        band.append(rows[ok] * nb + cc[ok])
    n_rand = int(random_density * nb * nb)
    rand = rng.choice(nb * nb, n_rand, replace=False)
    ids = np.unique(np.concatenate(band + [rand])).astype(np.int32)
    data = rng.standard_normal((ids.size, b, b)).astype(np.float32) / b
    return BlockMatrix(
        ids=torch.from_numpy(ids).to(device),
        data=torch.from_numpy(data).to(device),
        nnz=torch.tensor(ids.size, dtype=torch.int32, device=device),
        n_rows=nb * b,
        n_cols=nb * b,
        block_size=b,
    )
