"""Workload drivers built on the core ops (port of ``models/``):
density-matrix purification (SP2), matrix polynomials (Horner), the
Chebyshev expansion and the Newton-Schulz inverse square root."""

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
from hierarchical_block_sparse_lib_tpu_torch.models.polynomial import (
    HornerPlans,
    plan_polynomial,
    polynomial,
)
from hierarchical_block_sparse_lib_tpu_torch.models.inverse_factor import (
    NSPlans,
    inv_sqrt_newton_schulz,
    plan_inv_sqrt,
)
from hierarchical_block_sparse_lib_tpu_torch.models.chebyshev import (
    ChebPlans,
    chebyshev_apply,
    chebyshev_coeffs,
    plan_chebyshev,
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
    "HornerPlans",
    "plan_polynomial",
    "polynomial",
    "NSPlans",
    "inv_sqrt_newton_schulz",
    "plan_inv_sqrt",
    "ChebPlans",
    "chebyshev_apply",
    "chebyshev_coeffs",
    "plan_chebyshev",
]
