"""2-D mesh distributed SpGEMM: Cannon's algorithm (port of
``parallel/dist2d.py``).

Both operands are block-partitioned over a square ("r", "c") mesh: shard
(i, j) holds the blocks of row slab i and column slab j.  After the
pre-skew (A's row i shifted i steps left, B's column j shifted j steps
up) shard (i, j) holds A_{i,i+j} and B_{i+j,j}; p local
multiply-accumulates interleaved with A-left / B-up rotations give
C_{i,j} = sum_k A_{i,k} B_{k,j} in place.  Both rotations of a stage are
issued before its local products.  A distributed matrix is a
`DistBlockMatrix` with mesh shape (p, p) and global ids.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core import assembly
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL, BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import alpha_is_one_static, spgemm
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.parallel.dist import (
    overflow_flags,
    partition,
    ppermute_matrices,
    undistribute,
)
from hierarchical_block_sparse_lib_tpu_torch.parallel.mesh import (
    DistBlockMatrix,
    Mesh,
    make_grid,
    pmax,
    psum,
    with_shards,
)


def make_mesh2d(p: int | None = None, device=None) -> Mesh:
    """Square p x p mesh; p defaults to the largest square the cards hold
    (at least 1).  On the cards unless `device` names another."""
    if p is None:
        if device is not None:
            raise ValueError("make_mesh2d needs p when a device is given")
        p = max(math.isqrt(torch.cuda.device_count()), 1)
    return make_grid((p, p), ("r", "c"), device)


def distribute2d(m: BlockMatrix, mesh: Mesh) -> DistBlockMatrix:
    """Partition into (row-slab, col-slab) tiles over the 2-D mesh."""
    pr, pc = mesh.shape["r"], mesh.shape["c"]
    ids = m.ids.cpu().numpy()
    valid = ids != SENTINEL
    brow = np.where(valid, ids // m.nb_cols, 0)
    bcol = np.where(valid, ids % m.nb_cols, 0)
    dr = np.minimum(brow * pr // max(m.nb_rows, 1), pr - 1)
    dc = np.minimum(bcol * pc // max(m.nb_cols, 1), pc - 1)
    owner = np.where(valid, dr * pc + dc, -1)
    return partition(m, owner, mesh, (pr, pc))


def undistribute2d(m: DistBlockMatrix) -> BlockMatrix:
    return undistribute(m)


def _rotate_minus1(mesh: Mesh, ms: list, axis: str, p: int) -> list:
    """Shift shards one step towards lower index (left/up) on the ring."""
    return ppermute_matrices(mesh, ms, axis, [(i, (i - 1) % p) for i in range(p)])


def _skew(mesh: Mesh, ms: list, shift_axis: str, p: int) -> list:
    """Cannon pre-skew: along `shift_axis`, rotate each shard down by its
    index on the other axis (row i of A moves i steps left), as one
    permutation over the linearised ("r", "c") pair."""
    perm = []
    for r in range(p):
        for c in range(p):
            src = r * p + c
            if shift_axis == "c":
                dst = r * p + ((c - r) % p)
            else:
                dst = ((r - c) % p) * p + c
            perm.append((src, dst))
    return ppermute_matrices(mesh, ms, ("r", "c"), perm)


def dist2d_spgemm(
    a: DistBlockMatrix,
    b: DistBlockMatrix,
    mesh: Mesh,
    pair_cap: int,
    out_cap: int,
    stage_out_cap: int | None = None,
    alpha=1.0,
    backend: str = "auto",
    precision: str = "highest",
):
    """C = alpha * A @ B over a square 2-D mesh by Cannon's algorithm.

    `pair_cap`/`stage_out_cap` bound each shard's per-stage enumeration
    and stage output; `out_cap` the per-shard result tile.  Returns
    (C distributed, total_block_pairs, any_overflow)."""
    pr, pc = mesh.shape["r"], mesh.shape["c"]
    if pr != pc:
        raise ValueError(f"Cannon needs a square mesh, got {pr}x{pc}")
    p = pr
    a.on(mesh), b.on(mesh)
    stage_out_cap = stage_out_cap or out_cap
    a_cur = _skew(mesh, list(a.shards), "c", p)
    b_cur = _skew(mesh, list(b.shards), "r", p)
    c = [assembly.empty(s.n_rows, b.n_cols, s.block_size, out_cap, dtype=s.dtype,
                        device=s.device) for s in a.shards]
    pairs = [torch.zeros((), dtype=torch.int32, device=s.device) for s in a.shards]
    ovf = [torch.zeros((), dtype=torch.bool, device=s.device) for s in a.shards]
    for stage in range(p):
        last = stage + 1 == p
        a_nxt = None if last else _rotate_minus1(mesh, a_cur, "c", p)
        b_nxt = None if last else _rotate_minus1(mesh, b_cur, "r", p)
        for d in range(mesh.size):
            c_s, info = spgemm(a_cur[d], b_cur[d], pair_cap=pair_cap, out_cap=stage_out_cap,
                               backend=backend, precision=precision)
            c[d], add_ovf = basic.add_with_info(c[d], c_s, cap=out_cap)
            pairs[d] = pairs[d] + info.n_block_pairs
            ovf[d] = ovf[d] | overflow_flags(info) | add_ovf
        a_cur, b_cur = a_nxt, b_nxt
    if not alpha_is_one_static(alpha):
        c = [basic.scale(x, alpha) for x in c]
    total = psum(mesh, pairs, ("r", "c"))
    any_ovf = pmax(mesh, ovf, ("r", "c"))
    return with_shards(a, c), total[0], any_ovf[0]


def dist2d_frob_squared(m: DistBlockMatrix, mesh: Mesh) -> torch.Tensor:
    parts = [torch.sum(torch.square(s.data.to(torch.float32))) for s in m.on(mesh).shards]
    return psum(mesh, parts, ("r", "c"))[0]


def dist2d_truncate(m: DistBlockMatrix, mesh: Mesh, tau) -> DistBlockMatrix:
    """Truncation is shard-local under any block partition."""
    return with_shards(m, [truncate(s, tau) for s in m.on(mesh).shards])
