"""Distributed execution over a mesh of torch devices (port of the JAX
package's ``parallel/``).

- `mesh`: the mesh of logical shards, its collectives (`ppermute`,
  `psum`, `pmax`, `all_gather`) and the distributed matrix.
- `dist`: 1-D block-row partition and ring-SUMMA SpGEMM (B shards rotate,
  the next rotation issued before each stage's products).
- `dist2d`: square 2-D mesh, Cannon's algorithm.
- `route`: the sparsity-aware block router: a host-planned exact
  per-stage panel exchange that ships only the blocks each destination's
  products touch, with routed SpGEMM and routed SP2 purification.
- `route2`: two-level host x chip routing: union shares cross the "host"
  axis once per destination host, then an `all_gather` over the "chip"
  axis hands them on.

The program is one process: a shard's body runs in turn on its device,
and a collective moves tensors between shards.  On one card every shard
shares it and a move passes a reference; on several cards shards spread
in contiguous groups and a move is a peer copy.
"""

from hierarchical_block_sparse_lib_tpu_torch.parallel import (
    dist,
    dist2d,
    mesh,
    route,
    route2,
)

__all__ = ["dist", "dist2d", "mesh", "route", "route2"]
