"""Chebyshev expansion of matrix functions over block-sparse matrices
(port of ``models/chebyshev.py``): the Fermi-operator expansion,
f(H) ~= sum_k c_k T_k(H), with the recurrence

    T_0 = I,  T_1 = H,  T_{k+1} = 2 H T_k - T_{k-1}

each step one `spgemm` with the fused beta-accumulate (alpha = 2,
beta = -1), then a norm truncation, then the accumulator's add (planned
with `AddPlan` when the trajectory was captured).  H must be scaled into
[-1, 1] (e.g. by `gershgorin_bound`); `chebyshev_coeffs` turns samples of
f on [-1, 1] into the c_k.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.assembly import eye
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.ops import basic, repack as repack_mod
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import make_plan, spgemm
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate


def chebyshev_coeffs(f, order: int, n_samples: int = 256) -> np.ndarray:
    """Chebyshev coefficients of f on [-1, 1] (Gauss-Chebyshev points)."""
    k = np.arange(n_samples)
    x = np.cos(np.pi * (k + 0.5) / n_samples)
    fx = f(x)
    j = np.arange(order + 1)[:, None]
    c = (2.0 / n_samples) * (
        fx[None, :] * np.cos(j * np.pi * (k[None, :] + 0.5) / n_samples)
    ).sum(axis=1)
    c[0] /= 2.0
    return c


@dataclass(frozen=True)
class ChebPlans:
    """Per-term structural plans of a fixed Chebyshev trajectory
    (`plan_chebyshev`): the recurrence multiply's symbolic and union plan
    and the accumulator add's union plan.  The structure depends only on
    (H, tau, n_terms), since the coefficients only scale data, so one walk
    serves any coefficient vector of the same length.  Both plan kinds
    record the operand ids they were built for and check them on use, so
    drift (a data drift that changes a truncation decision included) folds
    into the returned overflow flag."""

    mul_plans: tuple  # tuple[SymbolicPlan], one per term k >= 2
    add_plans: tuple  # tuple[basic.AddPlan]


def plan_chebyshev(
    h: BlockMatrix,
    n_terms: int,
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    row_caps: tuple | None = None,
) -> ChebPlans:
    """Walk the recurrence once and capture every term's structural plans
    for ``chebyshev_apply(..., plans=...)``."""
    coeffs = np.zeros(n_terms)  # the values do not shape the structure
    return _cheb_loop(
        h, coeffs, tau, pair_cap, out_cap, backend, row_caps, plans=None, capture=True,
    )[3]


def chebyshev_apply(
    h: BlockMatrix,
    coeffs,
    tau,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    row_caps: tuple | None = None,
    plans: ChebPlans | None = None,
):
    """F = sum_k coeffs[k] * T_k(H), H pre-scaled to a spectrum in [-1, 1].

    Truncates each T_k to `tau` before it enters the recurrence.  Returns
    (F, total_block_pairs, overflow).  `plans` (from `plan_chebyshev` at
    the same caps and tau) freezes every term's symbolic, union and add
    structure; divergence from it folds into the overflow flag."""
    f_acc, total, ovf, _ = _cheb_loop(
        h, coeffs, tau, pair_cap, out_cap, backend, row_caps, plans=plans, capture=False,
    )
    return f_acc, total, ovf


def _cheb_loop(h, coeffs, tau, pair_cap, out_cap, backend, row_caps, plans, capture):
    n, b = h.n_rows, h.block_size
    coeffs = np.asarray(coeffs, np.float64)
    ident = eye(n, b, dtype=h.dtype, cap=-(-n // b), device=h.device)
    t_prev = repack_mod.repack(ident, out_cap)  # T_0
    t_cur = repack_mod.repack(h, out_cap)  # T_1
    # At cap=out_cap: the union of all T_k can exceed out_cap even when
    # each T_k fits, and that drop is reported.
    f_acc, ovf = basic.add_with_info(
        basic.scale(t_prev, float(coeffs[0])),
        basic.scale(t_cur, float(coeffs[1]) if len(coeffs) > 1 else 0.0),
        cap=out_cap,
    )
    total = torch.zeros((), dtype=torch.int32, device=h.device)
    mul_plans, add_plans = [], []
    for k in range(2, len(coeffs)):
        if capture:
            mul_plans.append(make_plan(h, t_cur, pair_cap, accum_ids=t_prev.ids, out_cap=out_cap))
        mp = mul_plans[-1] if capture else (plans.mul_plans[k - 2] if plans is not None else None)
        # T_{k+1} = 2 H T_k - T_{k-1} in one structural pass; with a plan
        # spgemm checks h, t_cur and t_prev against it (plan_mismatch).
        t_nxt, info = spgemm(
            h, t_cur, pair_cap=pair_cap, out_cap=out_cap, backend=backend,
            row_caps=row_caps, accum=t_prev, alpha=2.0, beta=-1.0, plan=mp,
        )
        t_nxt = truncate(t_nxt, tau)
        if capture:
            add_plans.append(basic.make_add_plan(f_acc.ids, t_nxt.ids, out_cap))
        ap = add_plans[-1] if capture else (plans.add_plans[k - 2] if plans is not None else None)
        if ap is not None:
            # add_planned checks f_acc and the freshly truncated t_nxt
            # against the planned ids: this catches a data drift that
            # changes the last term's truncation, which no later planned
            # op would see.
            f_acc, acc_ovf = basic.add_planned(f_acc, t_nxt, ap, beta=float(coeffs[k]))
        else:
            f_acc, acc_ovf = basic.add_with_info(f_acc, t_nxt, beta=float(coeffs[k]), cap=out_cap)
        total = total + info.n_block_pairs
        ovf = (
            ovf | acc_ovf | info.pair_overflow | info.out_overflow
            | info.row_overflow | info.plan_mismatch
        )
        t_prev, t_cur = t_cur, t_nxt
    cp = ChebPlans(mul_plans=tuple(mul_plans), add_plans=tuple(add_plans)) if capture else None
    return f_acc, total, ovf, cp
