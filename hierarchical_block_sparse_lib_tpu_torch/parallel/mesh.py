"""A mesh of torch devices, its collectives, and the distributed matrix.

The port's counterpart of ``jax.sharding.Mesh`` and of the four
collectives the JAX package's ``shard_map`` bodies use (``ppermute``,
``psum``, ``pmax``, ``all_gather``).  The JAX package runs every
distributed operation as one program over one process's devices; so does
the port: a `Mesh` is a grid of logical shards, each placed on a torch
device, and a distributed body runs once per shard in one process.  A
collective takes one value per shard (a list in flat, row-major mesh
order) and returns one per shard.

- A move is ``.to(dst, non_blocking=True)``: no copy when source and
  destination share a device (all shards of a one-card mesh), a peer copy
  between two cards.
- `psum` and `pmax` reduce in rank order along the axis, on the group's
  first device, so a result never depends on timing; no float atomics.
- Each collective that moves block payloads (tensors of rank >= 3, one
  block per leading row) appends its counts to ``mesh.traffic``.

`make_mesh_devices` places n logical shards in contiguous groups over the
cards; without a card and without ``device=`` it raises.

A distributed matrix (`DistBlockMatrix`) keeps one `BlockMatrix` per
shard, each on its shard's device, all at one capacity; ids stay global
block ids, so the local compute is the single-device ops unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL, BlockMatrix


def make_mesh_devices(n: int, device=None) -> list:
    """The torch device of each of `n` logical shards: all on `device` when
    it is given, else in contiguous groups over the CUDA cards (shard i on
    card ``i * cards // n``).  Without a card and without `device` it
    raises; it never falls back to the CPU."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return [dev] * n
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh is built on the cards by default; "
            "pass device='cpu' to build it on the CPU"
        )
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i * cards // n) for i in range(n)]


@dataclass
class Traffic:
    """Block payloads moved by a mesh's collectives: one entry per
    collective call, (name, blocks moved between distinct shards, of
    which between distinct devices).  A block is one leading row of a
    moved payload, padding rows included."""

    exchanges: list = field(default_factory=list)

    def reset(self) -> None:
        self.exchanges.clear()


class Mesh:
    """A grid of logical shards with named axes, as ``jax.sharding.Mesh``:
    `devices` is a numpy object array of `torch.device` shaped like the
    grid, `shape` maps each axis name to its size.  Flat rank r is the
    row-major index of a shard; `device(r)` is where it lives."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))
        self.traffic = Traffic()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, rank: int) -> torch.device:
        return self.devices.flat[rank]

    def groups(self, axis) -> np.ndarray:
        """int[n_groups, group_size]: the flat ranks of each group of a
        collective along `axis` (a name, or a tuple of names linearised
        row-major, as a JAX multi-axis collective), in axis-index order."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        pos = [self.axis_names.index(a) for a in axes]
        other = [i for i in range(self.devices.ndim) if i not in pos]
        ranks = np.arange(self.size).reshape(self.devices.shape)
        width = math.prod(self.devices.shape[p] for p in pos)
        return ranks.transpose(other + pos).reshape(-1, width)

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_grid(shape, axis_names, device=None) -> Mesh:
    """A mesh of ``prod(shape)`` shards named `axis_names`, placed by
    `make_mesh_devices`."""
    shape = tuple(int(s) for s in shape)
    devs = np.empty(math.prod(shape), dtype=object)
    devs[:] = make_mesh_devices(math.prod(shape), device)
    return Mesh(devs.reshape(shape), axis_names)


def _move(mesh: Mesh, x: torch.Tensor, src: int, dst: int, moved: list) -> torch.Tensor:
    dev = mesh.device(dst)
    if src != dst and x.dim() >= 3:
        moved[0] += x.shape[0]
        if x.device != dev:
            moved[1] += x.shape[0]
    return x.to(dev, non_blocking=True)


def _record(mesh: Mesh, name: str, moved: list) -> None:
    if moved[0]:
        mesh.traffic.exchanges.append((name, moved[0], moved[1]))


def ppermute(mesh: Mesh, xs: list, axis, perm) -> list:
    """``jax.lax.ppermute``: within each group along `axis`, the value of
    axis index `src` goes to index `dst` for every (src, dst) in `perm`;
    a shard that receives nothing gets zeros."""
    out = [None] * mesh.size
    moved = [0, 0]
    for g in mesh.groups(axis):
        for src, dst in perm:
            out[g[dst]] = _move(mesh, xs[g[src]], g[src], g[dst], moved)
    for r in range(mesh.size):
        if out[r] is None:
            out[r] = torch.zeros_like(xs[r])
    _record(mesh, "ppermute", moved)
    return out


def _reduce(mesh: Mesh, xs: list, axis, op) -> list:
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        first = mesh.device(g[0])
        acc = xs[g[0]]
        for r in g[1:]:
            acc = op(acc, xs[r].to(first, non_blocking=True))
        for r in g:
            out[r] = acc.to(mesh.device(r), non_blocking=True)
    return out


def psum(mesh: Mesh, xs: list, axis) -> list:
    """``jax.lax.psum``: every shard gets its group's sum, added in axis
    order on the group's first device."""
    return _reduce(mesh, xs, axis, torch.add)


def pmax(mesh: Mesh, xs: list, axis) -> list:
    """``jax.lax.pmax``: every shard gets its group's maximum (for bool
    values, their logical or)."""
    return _reduce(mesh, xs, axis, torch.maximum)


def all_gather(mesh: Mesh, xs: list, axis) -> list:
    """``jax.lax.all_gather`` (untiled): every shard gets the tuple of its
    group's values in axis order, each on the shard's own device."""
    out = [None] * mesh.size
    moved = [0, 0]
    for g in mesh.groups(axis):
        for dst in g:
            out[dst] = tuple(_move(mesh, xs[src], src, dst, moved) for src in g)
    _record(mesh, "all_gather", moved)
    return out


@dataclass(frozen=True)
class DistBlockMatrix:
    """A block-sparse matrix partitioned over a mesh: one `BlockMatrix` per
    logical shard in flat mesh order, each on its shard's device, all at
    the same capacity; ids are global block ids.  The JAX package stacks
    the shards on leading mesh dims (``[P, cap, b, b]``); `stacked_ids`
    gives that layout of the ids, which the host planners read."""

    shards: tuple
    mesh_shape: tuple

    def __post_init__(self):
        if len(self.shards) != math.prod(self.mesh_shape):
            raise ValueError(f"{len(self.shards)} shards for a mesh of {self.mesh_shape}")
        caps = {s.cap for s in self.shards}
        if len(caps) != 1:
            raise ValueError(f"shards at different capacities {sorted(caps)}")

    @property
    def n_rows(self) -> int:
        return self.shards[0].n_rows

    @property
    def n_cols(self) -> int:
        return self.shards[0].n_cols

    @property
    def block_size(self) -> int:
        return self.shards[0].block_size

    @property
    def nb_rows(self) -> int:
        return self.shards[0].nb_rows

    @property
    def nb_cols(self) -> int:
        return self.shards[0].nb_cols

    @property
    def cap(self) -> int:
        """Per-shard capacity."""
        return self.shards[0].cap

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def stacked_ids(self) -> np.ndarray:
        """int32[*mesh_shape, cap]: every shard's ids on the host."""
        ids = np.stack([s.ids.cpu().numpy() for s in self.shards])
        return ids.reshape(tuple(self.mesh_shape) + (self.cap,))

    def on(self, mesh: Mesh) -> "DistBlockMatrix":
        """Self, after checking that shard r lies on the device of `mesh`'s
        rank r (a matrix distributed for one placement cannot feed another's
        collectives)."""
        if len(self.shards) != mesh.size:
            raise ValueError(f"{len(self.shards)} shards on a mesh of {mesh.size}")
        for r, s in enumerate(self.shards):
            if s.device != mesh.device(r):
                raise ValueError(f"shard {r} on {s.device}, the mesh places it on {mesh.device(r)}")
        return self


def with_shards(m: DistBlockMatrix, shards) -> DistBlockMatrix:
    return DistBlockMatrix(tuple(shards), m.mesh_shape)


def shard_geometry(m) -> dict:
    """n_rows, n_cols and block_size of a matrix or a distributed matrix."""
    return dict(n_rows=m.n_rows, n_cols=m.n_cols, block_size=m.block_size)


def ids_only(ids: torch.Tensor, like) -> BlockMatrix:
    """A BlockMatrix of `ids` with `like`'s geometry and no payload: the
    symbolic phase reads ids and geometry only."""
    return BlockMatrix(
        ids=ids, data=torch.zeros((ids.shape[0], 0, 0), device=ids.device),
        nnz=(ids != SENTINEL).sum().to(torch.int32),
        **shard_geometry(like),
    )
