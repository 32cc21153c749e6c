"""Norm-based block truncation (port of ``ops/truncate.py``): per-block
or per-subtree norm -> mask -> stable compaction.  Capacity is unchanged
unless `cap` is given; freed slots become SENTINEL/zero padding.

On the card the compaction, and in leaf mode the norm and the compare, are
the two passes of ``kernels/truncate.py::truncate_kernel``; at b % 128 ==
0 with f32 or bf16 data the keep comes from the norms kernel
(``kernels/pallas_norms.py::norms_and_keep``) as before, and in subtree
mode from the node norms of `subtree_node_norms2`.  A CPU tensor takes the
plain version, `truncate_reference`."""

from __future__ import annotations

import dataclasses

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms
from hierarchical_block_sparse_lib_tpu_torch.kernels import truncate as truncate_kernels
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import (
    block_frob_squared,
    squared_threshold,
    subtree_node_norms2,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


def keep_reference(a: BlockMatrix, tau, subtree_level: int | None = None) -> torch.Tensor:
    """The plain version's keep mask: valid blocks whose frob norm (or whose
    level-`subtree_level` subtree's norm) is > tau."""
    # Threshold at the norm's accumulation type; a number is squared on
    # the host, so no scalar is copied to the device.
    tdt = torch.promote_types(a.dtype, torch.float32)
    if subtree_level is not None:
        keys, node_norms2 = subtree_node_norms2(a, subtree_level)
        keep = node_norms2[keys.long()] > squared_threshold(tau, tdt)
    elif pallas_norms.supported(a.block_size, a.dtype):
        _, keep = pallas_norms.norms_and_keep(a.data, tau)
    else:
        keep = block_frob_squared(a) > squared_threshold(tau, tdt)
    return keep & a.valid_mask()


def compact_reference(a: BlockMatrix, keep: torch.Tensor, cap: int | None = None):
    """The plain version's stable compaction of the blocks `keep` marks:
    (matrix, kept) as `truncate` returns them with `cap`."""
    # Stable compaction without a sort (ids are sorted): survivors' slots
    # are cumsum(keep)-1.  Invert the slot map with a small int scatter
    # (slot `ocap` is the trash row), then gather the blocks once; source
    # index `icap` reads the appended SENTINEL/zero row.
    ocap = a.cap if cap is None else cap
    icap = a.cap
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, ocap).clamp_(max=ocap)
    src = torch.full((ocap + 1,), icap, dtype=torch.int64, device=a.device)
    src[slot] = torch.arange(icap, device=a.device)
    src = src[:ocap]
    pad = src == icap
    srcc = src.clamp(max=icap - 1)
    out_ids = torch.where(pad, SENTINEL, a.ids[srcc]).to(torch.int32)
    out_data = torch.where(pad[:, None, None], 0, a.data[srcc])
    kept = keep.sum().to(torch.int32)
    m = dataclasses.replace(
        a, ids=out_ids, data=out_data, nnz=torch.clamp(kept, max=ocap)
    )
    return m, kept


def truncate_reference(
    a: BlockMatrix,
    tau,
    subtree_level: int | None = None,
    cap: int | None = None,
):
    """The plain version of `truncate`: torch reductions, a cumsum and a
    gather (`keep_reference`, then `compact_reference`)."""
    m, kept = compact_reference(a, keep_reference(a, tau, subtree_level), cap)
    return m if cap is None else (m, kept)


def truncate(
    a: BlockMatrix,
    tau,
    subtree_level: int | None = None,
    cap: int | None = None,
):
    """Drop blocks with frob norm <= tau; compact storage.

    With `subtree_level` set, drops whole quadtree subtrees at that level
    whose aggregate norm is <= tau (the reference's hierarchical pruning);
    the default is leaf-block truncation.

    With `cap` set, the compaction writes straight into `cap`-sized
    storage and the return value becomes ``(matrix, kept)``, where
    `kept` is the survivor count before the clamp: ``kept > cap`` means
    trailing (highest-id) survivors were dropped.
    """
    with span("hbsm.truncate"):
        if a.device.type == "cpu":
            return truncate_reference(a, tau, subtree_level, cap)
        keep = tau2 = None
        if subtree_level is not None or pallas_norms.supported(a.block_size, a.dtype):
            keep = keep_reference(a, tau, subtree_level)
        else:
            tau2 = squared_threshold(tau, torch.promote_types(a.dtype, torch.float32))
        ocap = a.cap if cap is None else cap
        ids, data, nnz, kept = truncate_kernels.truncate_kernel(
            a.ids, a.data, ocap, tau2=tau2, keep=keep
        )
        m = dataclasses.replace(a, ids=ids, data=data, nnz=nnz)
        return m if cap is None else (m, kept)
