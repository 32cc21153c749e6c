"""Inverse-factor / inverse-square-root iteration over block-sparse
matrices (port of ``models/inverse_factor.py``): Newton-Schulz, with a
norm truncation after every step keeping the iterates sparse,

    Z_0 = I / sqrt(theta)   (theta ~ ||S||, for convergence)
    T_k = (3 I - Z_k S Z_k) / 2       (two SpGEMMs, the second with the
                                       fused beta-accumulate)
    Z_{k+1} = Z_k T_k  ->  S^{-1/2}.

The reference's `lax.scan` is a Python loop here; every step carries the
flags of its three products, and no step waits for the device.  With
`cap`, each step compacts the truncated iterate into that capacity, so
the next step's products and passes walk no padding of `out_cap`.

`profile_inv_sqrt` measures a trajectory's exact capacity needs, and
`InvSqrtEngine` profiles and plans once and reuses the plans while S's
structure holds, as `PurifyEngine` does for SP2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.assembly import eye
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.models.engine import (
    CapacityProfile,
    PlannedEngine,
    ids_differ,
    next_pow2,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import gershgorin_bound
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    _max_row_count,
    make_plan,
    plan_spgemm_ex,
    spgemm,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


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


def _step(z, s, ident, pair_cap, out_cap, backend, row_caps, tau, plans, capture, cap):
    """One Newton-Schulz step: (Z', infos of the three products, the
    plans it ran with, whether the truncated Z' overflowed `cap`)."""
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
    z2, kept = truncate(z2, tau, cap=cap)
    return z2, (i1, i2, i3), (pz, pt, p2), kept > cap


def plan_inv_sqrt(
    s: BlockMatrix,
    theta: float,
    n_steps: int,
    tau: float,
    pair_cap: int,
    out_cap: int,
    backend: str = "auto",
    row_caps: tuple | None = None,
    cap: int | None = None,
) -> NSPlans:
    """Walk the Newton-Schulz iteration once (the same ops at the same
    caps) and capture every step's structural plans."""
    cap = out_cap if cap is None else cap
    z, ident = _z0(s, theta, cap), _identity(s)
    steps = []
    for _ in range(n_steps):
        z, _, p, _ = _step(z, s, ident, pair_cap, out_cap, backend, row_caps, tau, (None,) * 3,
                           True, cap)
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
    cap: int | None = None,
):
    """Z ~= S^{-1/2} by Newton-Schulz with per-step truncation.

    `theta` must satisfy theta > ||S||_2 / sqrt(3) for Z_0 = I/sqrt(theta)
    to converge (any upper bound on ||S||_2 works, e.g. a Frobenius
    norm).  Returns (Z, total_block_pairs, overflow).  `plans` (from
    `plan_inv_sqrt` at the same caps) freezes every step's symbolic and
    union structure; drift off it folds into the overflow flag.  `cap`
    (default: Z stays at `out_cap`) is Z's capacity: Z_0 and every
    truncated iterate are compacted into it, and a truncation that keeps
    more blocks folds into the overflow flag.
    """
    cap = out_cap if cap is None else cap
    with span("hbsm.inv_sqrt"):
        z, ident = _z0(s, theta, cap), _identity(s)
        total = torch.zeros((), dtype=torch.int32, device=s.device)
        ovf = torch.zeros((), dtype=torch.bool, device=s.device)
        for k in range(n_steps):
            step_plans = ((None,) * 3 if plans is None
                          else (plans.p_zy[k], plans.p_t[k], plans.p_z2[k]))
            z, infos, _, z_over = _step(z, s, ident, pair_cap, out_cap, backend, row_caps, tau,
                                        step_plans, False, cap)
            ovf = ovf | z_over
            for i in infos:
                total = total + i.n_block_pairs
                ovf = ovf | i.pair_overflow | i.out_overflow | i.row_overflow | i.plan_mismatch
        return z, total, ovf


def _profiled(a: BlockMatrix, b: BlockMatrix, backend: str, accum: BlockMatrix | None = None,
              **kw):
    """One product of the dry run at sure capacities from the exact host
    plan: (C, its exact needs: pairs, output blocks, largest B row and
    largest output row, the accumulator's blocks included)."""
    pc, oc, mbr, _ = plan_spgemm_ex(a, b)
    # The accumulator's blocks join the union; no output row holds more
    # than B's block columns.
    extra = 0 if accum is None else int(accum.nnz)
    c, info = spgemm(
        a, b, pair_cap=next_pow2(max(pc, 1)), out_cap=next_pow2(max(oc + extra, 1)),
        backend=backend, row_caps=(next_pow2(max(mbr, 1)), b.nb_cols), accum=accum, **kw,
    )
    if bool(info.pair_overflow | info.out_overflow | info.row_overflow):
        raise RuntimeError(
            "profile_inv_sqrt: overflow despite the exact host plan: planner and op disagree"
        )
    c_row = int(_max_row_count(c.ids, a.nb_rows, b.nb_cols))
    return c, (pc, int(info.n_out_blocks), mbr, c_row)


def profile_inv_sqrt(
    s: BlockMatrix,
    theta,
    n_steps: int,
    tau,
    backend: str = "auto",
    margin: float = 1.0,
) -> CapacityProfile:
    """Dry-run `n_steps` Newton-Schulz steps, host-planning each of the
    three products' exact needs, and return their tight maxima: one
    `pair_cap` and one `out_cap` for Z S, (Z S) Z + identity and Z T, the
    truncated iterate's `cap` (Z_0's identity included) and the row caps
    (the largest B row and the largest output row of any product).  The
    trajectory is bit-identical to the final run: capacities only decide
    whether blocks are dropped.  Each per-step entry holds the three
    products' needs in order.  `margin > 1` loosens the returned caps for
    nearby structures."""
    z, ident = _z0(s, theta, s.nb_rows), _identity(s)
    pairs_l, out_l, kept_l, b_rows, c_rows = [], [], [], [], []
    for _ in range(n_steps):
        zy, n1 = _profiled(z, s, backend)
        t, n2 = _profiled(zy, z, backend, alpha=-0.5, accum=ident, beta=1.5)
        z2, n3 = _profiled(z, t, backend)
        z, kept = truncate(z2, tau, cap=z2.cap)
        needs = (n1, n2, n3)
        pairs_l.append(tuple(n[0] for n in needs))
        out_l.append(tuple(n[1] for n in needs))
        kept_l.append(int(kept))
        b_rows += [n[2] for n in needs]
        c_rows += [n[3] for n in needs]

    def grow(v):
        return int(np.ceil(max(v) * margin))

    return CapacityProfile(
        pair_cap=grow(sum(pairs_l, ())),
        out_cap=grow(sum(out_l, ())),
        cap=grow([s.nb_rows] + kept_l),
        row_caps=(grow(b_rows), grow(c_rows)),
        per_step_pairs=tuple(pairs_l),
        per_step_out=tuple(out_l),
        per_step_kept=tuple(kept_l),
    )


class InvSqrtEngine(PlannedEngine):
    """Z ~= S^{-1/2} for a run of overlap matrices that share one
    structure (an SCF loop or the steps of a molecular-dynamics run):
    `profile_inv_sqrt` and `plan_inv_sqrt` in the first `run` (capacities
    rounded up to powers of two, Z compacted into the profile's `cap`),
    then the planned iteration; a replan before running when S's ids left
    the planned S's, and once more, then a rerun, when a run reports an
    overflow or a plan mismatch.  theta is `gershgorin_bound(S)`, kept on
    the device.  `run(s)` returns (Z, total_block_pairs, overflow)."""

    SPAN = "hbsm.inv_sqrt"

    def __init__(self, n_steps: int, tau: float, backend: str = "auto", margin: float = 1.25):
        super().__init__()
        self.n_steps = n_steps
        self.tau = tau
        self.backend = backend
        self.margin = margin

    def _profile(self, s: BlockMatrix) -> CapacityProfile:
        return profile_inv_sqrt(s, gershgorin_bound(s), self.n_steps, self.tau,
                                backend=self.backend, margin=self.margin)

    def _plan(self, s: BlockMatrix) -> NSPlans:
        return plan_inv_sqrt(s, gershgorin_bound(s), self.n_steps, self.tau,
                             backend=self.backend, **self.prof.kwargs())

    def _run_planned(self, s: BlockMatrix):
        return inv_sqrt_newton_schulz(s, gershgorin_bound(s), self.n_steps, self.tau,
                                      backend=self.backend, plans=self.plans,
                                      **self.prof.kwargs())

    @staticmethod
    def _failed(out) -> torch.Tensor:
        return out[2]

    def _stale(self, s: BlockMatrix) -> bool:
        """S's ids against the planned S's (Z S's B operand), capacity too."""
        with span("hbsm.engine_check"):
            planned = self.plans.p_zy[0].b_ids
            return s.ids.shape != planned.shape or ids_differ(s.ids, planned)
