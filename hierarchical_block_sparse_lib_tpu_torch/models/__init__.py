"""Workload drivers built on the core ops (port of ``models/``): so far
density-matrix purification (SP2)."""

from hierarchical_block_sparse_lib_tpu_torch.models.purification import (
    CapacityProfile,
    PurificationStats,
    PurifyEngine,
    PurifyPlans,
    plan_purify,
    profile_purify,
    purify,
    purify_scan,
    sp2_step,
)

__all__ = [
    "CapacityProfile",
    "PurificationStats",
    "PurifyEngine",
    "PurifyPlans",
    "plan_purify",
    "profile_purify",
    "purify",
    "purify_scan",
    "sp2_step",
]
