"""Matrix polynomials over the block-sparse format (port of
``models/polynomial.py``): p(A) = sum_k c_k A^k in Horner form, each step
one `spgemm` with the fused beta-accumulate (acc <- acc @ A + c I), then a
norm truncation, the error-controlled iteration of BASELINE.json:9.

`polynomial` passes no row caps, as the reference's does, so "auto"
takes the pair-stream kernel at 128-wide leaves.  Flags and counters
stay 0-dim tensors: no step waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.assembly import eye
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import make_plan, spgemm
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate


@dataclass(frozen=True)
class HornerPlans:
    """Per-step structural plans of a fixed Horner trajectory
    (`plan_polynomial`).  Horner's supports depend on the coefficients
    (truncation sees c_k I folded into the accumulator), so plans are per
    (A, coeffs, tau): the reuse regime is repeated evaluation under data
    drift with a frozen structure.  Each plan records the operand ids it
    was built for; spgemm checks them on use and drift folds into the
    returned overflow flag."""

    mul_plans: tuple  # tuple[SymbolicPlan with union fields]


def plan_polynomial(
    a: BlockMatrix,
    coeffs: Sequence[float],
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
) -> HornerPlans:
    """Walk the Horner evaluation once and capture every step's
    symbolic and union plan for ``polynomial(..., plans=...)``."""
    return _horner(a, coeffs, tau, pair_cap, out_cap, backend, plans=None, capture=True)[3]


def polynomial(
    a: BlockMatrix,
    coeffs: Sequence[float],
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    plans: HornerPlans | None = None,
):
    """Horner evaluation p(A) = c0 I + c1 A + ... + cn A^n with truncation
    after every multiply.  Returns (P, total_block_pairs, overflow):
    `overflow` is True if any multiply exceeded pair_cap/out_cap (the
    result is then incomplete: raise the caps) or left its plan.

    `plans` (from `plan_polynomial` at the same coeffs, caps and tau)
    freezes every step's structure; drift folds into the overflow flag."""
    p, total, ovf, _ = _horner(a, coeffs, tau, pair_cap, out_cap, backend, plans, capture=False)
    return p, total, ovf


def _horner(a, coeffs, tau, pair_cap, out_cap, backend, plans, capture):
    ident = eye(a.n_rows, a.block_size, dtype=a.dtype, cap=a.nb_rows, device=a.device)
    acc = basic.scale(ident, coeffs[-1])
    total_pairs = torch.zeros((), dtype=torch.int32, device=a.device)
    overflow = torch.zeros((), dtype=torch.bool, device=a.device)
    mul_plans = []
    for k, c in enumerate(reversed(coeffs[:-1])):
        if capture:
            mul_plans.append(make_plan(acc, a, pair_cap, accum_ids=ident.ids, out_cap=out_cap))
        mp = mul_plans[-1] if capture else (plans.mul_plans[k] if plans is not None else None)
        # acc <- acc @ A + c I in one structural pass (the fused
        # beta-accumulate); a union past out_cap is out_overflow, and with
        # a plan spgemm checks acc, A and I against it (plan_mismatch).
        acc, info = spgemm(
            acc, a, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            accum=ident, beta=c, plan=mp,
        )
        total_pairs = total_pairs + info.n_block_pairs
        overflow = (
            overflow | info.pair_overflow | info.out_overflow
            | info.row_overflow | info.plan_mismatch
        )
        acc = truncate(acc, tau)
    hp = HornerPlans(mul_plans=tuple(mul_plans)) if capture else None
    return acc, total_pairs, overflow, hp
