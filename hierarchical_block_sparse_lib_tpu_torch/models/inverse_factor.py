"""Inverse-factor / inverse-square-root iteration over block-sparse
matrices (port of ``models/inverse_factor.py``): Newton-Schulz, with a
norm truncation after every step keeping the iterates sparse,

    Z_0 = I / sqrt(theta)   (theta ~ ||S||, for convergence)
    T_k = (3 I - Z_k S Z_k) / 2       (two SpGEMMs, the second with the
                                       fused beta-accumulate)
    Z_{k+1} = Z_k T_k  ->  S^{-1/2}.

The reference's `lax.scan` is a Python loop here; every step carries the
flags of its three products, and no step waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.assembly import eye
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import make_plan, spgemm
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate


@dataclass(frozen=True)
class NSPlans:
    """Per-step structural plans of a fixed Newton-Schulz trajectory
    (`plan_inv_sqrt`): the three multiplies' symbolic (and union) plans,
    one tuple entry per step (the reference stacks them over a leading
    [n_steps] axis).  Each plan records the operand ids it was built for
    and spgemm checks them on use, so drift off the planned trajectory
    (of the constant S too) folds into the returned overflow flag."""

    p_zy: tuple  # tuple[SymbolicPlan]: Z @ S
    p_t: tuple  # tuple[SymbolicPlan with union fields]: -0.5 (ZS) @ Z + 1.5 I
    p_z2: tuple  # tuple[SymbolicPlan]: Z @ T


def _z0(s: BlockMatrix, theta, out_cap: int) -> BlockMatrix:
    """I / sqrt(theta) at capacity out_cap, the factor taken in f32 as the
    reference takes it (a number on the host, a tensor on its device)."""
    if isinstance(theta, torch.Tensor):
        inv = (1.0 / torch.sqrt(theta.to(torch.float32))).to(s.dtype)
    else:
        inv = float(np.float32(1.0) / np.sqrt(np.float32(theta)))
    return basic.scale(
        eye(s.n_rows, s.block_size, dtype=s.dtype, cap=out_cap, device=s.device), inv
    )


def _identity(s: BlockMatrix) -> BlockMatrix:
    return eye(s.n_rows, s.block_size, dtype=s.dtype, cap=s.nb_rows, device=s.device)


def _step(z, s, ident, pair_cap, out_cap, backend, row_caps, tau, plans, capture):
    """One Newton-Schulz step: (Z', infos of the three products, the
    plans it ran with)."""
    kw = dict(pair_cap=pair_cap, out_cap=out_cap, backend=backend, row_caps=row_caps)
    pz, pt, p2 = plans
    if capture:
        pz = make_plan(z, s, pair_cap)
    zy, i1 = spgemm(z, s, plan=pz, **kw)
    if capture:
        pt = make_plan(zy, z, pair_cap, accum_ids=ident.ids, out_cap=out_cap)
    # T = 1.5 I - 0.5 ZSZ in one structural pass (the fused
    # beta-accumulate; a union past out_cap is out_overflow).
    t, i2 = spgemm(zy, z, alpha=-0.5, accum=ident, beta=1.5, plan=pt, **kw)
    if capture:
        p2 = make_plan(z, t, pair_cap)
    z2, i3 = spgemm(z, t, plan=p2, **kw)
    return truncate(z2, tau), (i1, i2, i3), (pz, pt, p2)


def plan_inv_sqrt(
    s: BlockMatrix,
    theta: float,
    n_steps: int,
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    row_caps: tuple | None = None,
) -> NSPlans:
    """Walk the Newton-Schulz iteration once (the same ops at the same
    caps) and capture every step's structural plans."""
    z, ident = _z0(s, theta, out_cap), _identity(s)
    steps = []
    for _ in range(n_steps):
        z, _, p = _step(z, s, ident, pair_cap, out_cap, backend, row_caps, tau, (None,) * 3, True)
        steps.append(p)
    return NSPlans(*(tuple(p[i] for p in steps) for i in range(3)))


def inv_sqrt_newton_schulz(
    s: BlockMatrix,
    theta,
    n_steps: int,
    tau,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    row_caps: tuple | None = None,
    plans: NSPlans | None = None,
):
    """Z ~= S^{-1/2} by Newton-Schulz with per-step truncation.

    `theta` must satisfy theta > ||S||_2 / sqrt(3) for Z_0 = I/sqrt(theta)
    to converge (any upper bound on ||S||_2 works, e.g. a Frobenius
    norm).  Returns (Z, total_block_pairs, overflow).  `plans` (from
    `plan_inv_sqrt` at the same caps) freezes every step's symbolic and
    union structure; drift off it folds into the overflow flag.
    """
    z, ident = _z0(s, theta, out_cap), _identity(s)
    total = torch.zeros((), dtype=torch.int32, device=s.device)
    ovf = torch.zeros((), dtype=torch.bool, device=s.device)
    for k in range(n_steps):
        step_plans = (None,) * 3 if plans is None else (plans.p_zy[k], plans.p_t[k], plans.p_z2[k])
        z, infos, _ = _step(z, s, ident, pair_cap, out_cap, backend, row_caps, tau, step_plans,
                            False)
        for i in infos:
            total = total + i.n_block_pairs
            ovf = ovf | i.pair_overflow | i.out_overflow | i.row_overflow | i.plan_mismatch
    return z, total, ovf
