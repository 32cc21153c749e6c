"""Distributed block-sparse matrices over a device mesh: the 1-D block-row
partition and ring SUMMA (port of ``parallel/dist.py``).

Shard d owns the block-row slab ``[d*nbr/P, (d+1)*nbr/P)``.  A and C are
row-partitioned, so C's block row i comes only from A's block row i and
the accumulate is shard-local; B circulates around the ring, one shard
per stage.  Each stage issues the next rotation before its local
products, so on several cards the peer copy overlaps the products (on
one card the rotation passes references).  Norm and trace reductions
are `psum`.

A distributed matrix is a `DistBlockMatrix` (one `BlockMatrix` per shard,
global ids), so the local compute is the single-device `spgemm`,
`add_with_info` and `truncate` unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core import assembly
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    compact_sorted,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import trace as _trace
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import alpha_is_one_static, spgemm
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.parallel.mesh import (
    DistBlockMatrix,
    Mesh,
    make_grid,
    pmax,
    ppermute,
    psum,
    with_shards,
)


def make_mesh(n_devices: int | None = None, axis: str = "p", device=None) -> Mesh:
    """A 1-D mesh of `n_devices` logical shards (default: one per card),
    on the cards unless `device` names another."""
    if n_devices is None:
        n_devices = 1 if device is not None else max(torch.cuda.device_count(), 1)
    return make_grid((n_devices,), (axis,), device)


def owner_of_block_row(brow, nbr: int, n_dev: int):
    """Shard owning a block row (an int array or tensor): equal contiguous
    slabs."""
    owner = brow * n_dev // max(nbr, 1)
    if isinstance(owner, torch.Tensor):
        return owner.clamp(max=n_dev - 1)
    return np.minimum(owner, n_dev - 1)


def partition(m: BlockMatrix, owner: np.ndarray, mesh: Mesh, mesh_shape) -> DistBlockMatrix:
    """Shard r of the result holds m's blocks with ``owner == r`` (host
    ints, -1 for none), in m's (sorted) order, at the capacity of the
    fullest shard.  Blocks move by one gather on m's device and one copy
    to the shard's device, never through the host."""
    n = mesh.size
    counts = np.bincount(owner[owner >= 0], minlength=n)
    cap_local = max(int(counts.max()), 1)
    ids = m.ids.cpu().numpy()
    shards = []
    for r in range(n):
        sel = np.nonzero(owner == r)[0]
        dev = mesh.device(r)
        sid = np.full(cap_local, SENTINEL, np.int32)
        sid[: sel.size] = ids[sel]
        data = torch.zeros((cap_local,) + tuple(m.data.shape[1:]), dtype=m.dtype, device=dev)
        if sel.size:
            idx = torch.from_numpy(sel).to(m.device)
            data[: sel.size] = m.data.index_select(0, idx).to(dev)
        shards.append(BlockMatrix(
            ids=torch.from_numpy(sid).to(dev), data=data,
            nnz=torch.tensor(sel.size, dtype=torch.int32, device=dev),
            n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size,
        ))
    return DistBlockMatrix(tuple(shards), tuple(mesh_shape))


def distribute(m: BlockMatrix, mesh: Mesh, axis: str = "p") -> DistBlockMatrix:
    """Partition a matrix by block-row slab over the mesh's `axis` (the
    whole mesh: shard d on the device of flat rank d)."""
    n_dev = mesh.shape[axis]
    if n_dev != mesh.size:
        raise ValueError(f"distribute partitions the whole mesh: {axis!r} has {n_dev} of "
                         f"its {mesh.size} shards")
    ids = m.ids.cpu().numpy()
    valid = ids != SENTINEL
    brow = np.where(valid, ids // m.nb_cols, 0)
    owner = np.where(valid, owner_of_block_row(brow, m.nb_rows, n_dev), -1)
    return partition(m, owner, mesh, (n_dev,))


def undistribute(m: DistBlockMatrix) -> BlockMatrix:
    """Gather a distributed matrix back to one canonical matrix, on the
    device of shard 0."""
    dev = m.shards[0].device
    ids = torch.cat([s.ids.to(dev) for s in m.shards])
    data = torch.cat([s.data.to(dev) for s in m.shards])
    out_ids, out_data, nnz = compact_sorted(ids, data, ids.shape[0])
    return BlockMatrix(ids=out_ids, data=out_data, nnz=nnz, n_rows=m.n_rows,
                       n_cols=m.n_cols, block_size=m.block_size)


def ppermute_matrices(mesh: Mesh, ms: list, axis, perm) -> list:
    """`ppermute` of one BlockMatrix per shard (ids, blocks and nnz)."""
    moved = [ppermute(mesh, [getattr(m, f) for m in ms], axis, perm)
             for f in ("ids", "data", "nnz")]
    return [BlockMatrix(ids=i, data=d, nnz=n, n_rows=m.n_rows, n_cols=m.n_cols,
                        block_size=m.block_size)
            for i, d, n, m in zip(*moved, ms)]


def _ring_next(mesh: Mesh, ms: list, axis: str) -> list:
    """Rotate shards one step around the ring (stage s -> s+1)."""
    n = mesh.shape[axis]
    return ppermute_matrices(mesh, ms, axis, [(i, (i + 1) % n) for i in range(n)])


def overflow_flags(info) -> torch.Tensor:
    """Any capacity overflow a MultiplyInfo reports."""
    return info.pair_overflow | info.out_overflow | info.row_overflow


def ring_product(a_shards, b_shards, mesh: Mesh, axis: str, pair_cap: int, out_cap: int,
                 stage_out_cap: int, backend: str, precision: str, row_caps):
    """Ring SUMMA over the shards: per shard (C, pairs, overflow), C =
    A_d @ B summed over the P stages at capacity `out_cap`.  Each stage
    issues the next rotation before its local products; the last stage
    issues none (its result would go unused)."""
    n_dev = mesh.shape[axis]
    c = [assembly.empty(a.n_rows, b_shards[0].n_cols, a.block_size, out_cap, dtype=a.dtype,
                        device=a.device) for a in a_shards]
    pairs = [torch.zeros((), dtype=torch.int32, device=a.device) for a in a_shards]
    ovf = [torch.zeros((), dtype=torch.bool, device=a.device) for a in a_shards]
    b_cur = list(b_shards)
    for stage in range(n_dev):
        b_nxt = _ring_next(mesh, b_cur, axis) if stage + 1 < n_dev else None
        for d, a in enumerate(a_shards):
            c_s, info = spgemm(a, b_cur[d], pair_cap=pair_cap, out_cap=stage_out_cap,
                               row_caps=row_caps, backend=backend, precision=precision)
            c[d], add_ovf = basic.add_with_info(c[d], c_s, cap=out_cap)
            pairs[d] = pairs[d] + info.n_block_pairs
            ovf[d] = ovf[d] | overflow_flags(info) | add_ovf
        b_cur = b_nxt
    return c, pairs, ovf


def dist_spgemm(
    a: DistBlockMatrix,
    b: DistBlockMatrix,
    mesh: Mesh,
    pair_cap: int,
    out_cap: int,
    stage_out_cap: int | None = None,
    alpha=1.0,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    row_caps: tuple | None = None,
):
    """Distributed C = alpha * A @ B with ring-rotated B shards.

    `pair_cap`/`stage_out_cap` are per-shard per-stage capacities (the
    worst case over stages and shards); `out_cap` is the per-shard
    capacity of the result; `row_caps` the worst-case per-stage
    (max_b_row, max_c_row), which sends the local stages to the row-panel
    kernel (`route.plan_route` gives exact per-stage caps).  Returns
    (C distributed, total block pairs over all shards, any overflow)."""
    a.on(mesh), b.on(mesh)
    stage_out_cap = stage_out_cap or out_cap
    c, pairs, ovf = ring_product(a.shards, b.shards, mesh, axis, pair_cap, out_cap,
                                 stage_out_cap, backend, precision, row_caps)
    if not alpha_is_one_static(alpha):
        c = [basic.scale(x, alpha) for x in c]
    total = psum(mesh, pairs, axis)
    any_ovf = pmax(mesh, ovf, axis)
    return with_shards(a, c), total[0], any_ovf[0]


def dist_frob_squared(m: DistBlockMatrix, mesh: Mesh, axis: str = "p") -> torch.Tensor:
    """Squared Frobenius norm: per-shard f32 sums of squares, then psum."""
    parts = [torch.sum(torch.square(s.data.to(torch.float32))) for s in m.on(mesh).shards]
    return psum(mesh, parts, axis)[0]


def dist_truncate(m: DistBlockMatrix, mesh: Mesh, tau, axis: str = "p") -> DistBlockMatrix:
    """Truncation is shard-local under any block partition."""
    del axis
    return with_shards(m, [truncate(s, tau) for s in m.on(mesh).shards])


def dist_trace(m: DistBlockMatrix, mesh: Mesh, axis: str = "p") -> torch.Tensor:
    """Global trace: shard-local diagonal-block traces, then psum."""
    return psum(mesh, [_trace(s) for s in m.on(mesh).shards], axis)[0]


def sp2_blend(x2: BlockMatrix, x: BlockMatrix, t: torch.Tensor, target_trace, tau, x_cap: int):
    """X_next = (2s-1)*X^2 + (2-2s)*X with s = [trace > target] (the
    branch-free blend of `models.sp2_step`), truncated straight into
    `x_cap`.  Returns (X_next, overflow of the truncation)."""
    target = target_trace.to(t.dtype) if isinstance(target_trace, torch.Tensor) else target_trace
    s = (t > target).to(x.dtype)
    y = basic.add(x2, x, alpha=2.0 * s - 1.0, beta=2.0 - 2.0 * s)
    y, kept = truncate(y, tau, cap=x_cap)
    return y, kept > x_cap


def dist_sp2_step(
    x: DistBlockMatrix,
    mesh: Mesh,
    tau,
    pair_cap: int,
    out_cap: int,
    stage_out_cap: int | None = None,
    target_trace=0.0,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    cap: int | None = None,
    row_caps: tuple | None = None,
):
    """One distributed SP2 purification step: ring X @ X, the
    trace-selected blend and shard-local truncation.

    The row partition makes every op but the multiply shard-local, and
    the trace needs one psum.  `cap` is the per-shard iterate capacity
    after truncation (default `out_cap`: the iterate densifies toward the
    union support before it re-sparsifies).  Returns (X_next distributed,
    stats dict: trace, n_block_pairs, overflow)."""
    x.on(mesh)
    stage_out_cap = stage_out_cap or out_cap
    x_cap = out_cap if cap is None else cap
    t = psum(mesh, [_trace(s) for s in x.shards], axis)
    x2, pairs, ovf = ring_product(x.shards, x.shards, mesh, axis, pair_cap, out_cap,
                                  stage_out_cap, backend, precision, row_caps)
    ys = []
    for d, s in enumerate(x.shards):
        y, over = sp2_blend(x2[d], s, t[d], target_trace, tau, x_cap)
        ys.append(y)
        ovf[d] = ovf[d] | over
    total = psum(mesh, pairs, axis)
    any_ovf = pmax(mesh, ovf, axis)
    return with_shards(x, ys), dict(trace=t[0], n_block_pairs=total[0], overflow=any_ovf[0])
