"""SP2 density-matrix purification, the flagship workload (port of
``models/purification.py``): repeated C = X*X with norm-based block
dropping (BASELINE.json:9).  Each step squares the iterate (`spgemm`
with a fused beta-accumulate), blends it by the trace rule, truncates
near-zero blocks and records exact counters.

A step runs at fixed capacities and never waits for the device: flags
and counters stay 0-dim tensors.  The host reads the device only where
the reference does too: `profile_purify`, `plan_purify` and
`PurifyEngine`.  With ``symmetric=True`` a step computes only the
upper-triangle products of X @ X (X = X^T) and mirrors the rest.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import basic, repack as repack_mod
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import trace
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    SymbolicPlan,
    make_plan,
    plan_spgemm_ex,
    spgemm,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate


@dataclass(frozen=True)
class PurificationStats:
    trace: torch.Tensor
    nnz_blocks: torch.Tensor
    n_block_pairs: torch.Tensor
    pair_overflow: torch.Tensor
    out_overflow: torch.Tensor
    # The truncated iterate exceeded the step's capacity and trailing
    # blocks were dropped (raise `cap` or loosen tau).
    repack_overflow: torch.Tensor
    # Distinct blocks of the pre-truncation result (product support union
    # X's support): the step's exact `out_cap` need.
    nnz_union: torch.Tensor
    # A plan was used but the iterate's structure left the planned
    # trajectory: the step's output is wrong.  Always False unplanned.
    plan_mismatch: torch.Tensor


_STAT_FIELDS = tuple(f.name for f in dataclasses.fields(PurificationStats))
_PLAN_FIELDS = tuple(f.name for f in dataclasses.fields(SymbolicPlan))


def sp2_step(
    x: BlockMatrix,
    tau,
    pair_cap: int,
    out_cap: int,
    target_trace=0.0,
    backend: str = "auto",
    cap: int | None = None,
    row_caps: tuple | None = None,
    symmetric: bool = False,
    plan: SymbolicPlan | None = None,
):
    """One SP2 (trace-correcting purification) step with truncation:

        X <- X @ X         if trace(X) > target
        X <- 2X - X @ X    otherwise

    as the fused C = (2s-1)*X@X + (2-2s)*X with s = [trace > target]
    (one structural pass, no branch), then drop blocks with Frobenius
    norm <= tau straight into capacity `cap` (default cap(x); overflow is
    reported in the stats).  Returns (X_next, PurificationStats).

    With `symmetric=True` (X symmetric, the physical case) only the
    upper-triangle products of X @ X run and the lower triangle is
    mirrored, so the iterate is symmetric element for element and
    `n_block_pairs` counts the products done, about half.  Unplanned,
    the step accumulates beta * triu(X) into an upper-only product,
    truncates it and rebuilds the lower triangle (`symmetrize_upper`).
    With a plan from ``make_plan(..., sym_mirror=True)`` it fills the
    generic union slots with upper products (the row-panel kernel skips
    the lower ones) and overwrites the strictly lower slots with
    transposed upper blocks through the plan's `mirror_src`: no
    structural work per step."""
    cap = x.cap if cap is None else cap
    t = trace(x)
    target = target_trace.to(t.dtype) if isinstance(target_trace, torch.Tensor) else target_trace
    s = (t > target).to(x.dtype)
    alpha, beta = 2.0 * s - 1.0, 2.0 - 2.0 * s
    kw = dict(pair_cap=pair_cap, out_cap=out_cap, backend=backend, row_caps=row_caps,
              alpha=alpha, beta=beta)
    if symmetric and plan is not None:
        if plan.mirror_src is None:
            raise ValueError(
                "sp2_step(symmetric=True, plan=...) needs a plan built with "
                "make_plan(..., sym_mirror=True)"
            )
        y, info = spgemm(x, x, accum=x, plan=plan, syrk_upper=True, **kw)
        nb = y.nb_cols
        yv = y.valid_mask()
        lower = yv & (y.ids // nb > y.ids % nb)
        diag = yv & (y.ids // nb == y.ids % nb)
        data = torch.where(
            lower[:, None, None], y.data[plan.mirror_src.long()].transpose(-1, -2), y.data
        )
        # A diagonal block of an upper-only product is symmetric only to
        # rounding: average it with its transpose (symmetrize_upper's rule).
        data = torch.where(diag[:, None, None], 0.5 * (data + data.transpose(-1, -2)), data)
        y, nnz_kept = truncate(y.with_data(data), tau, cap=cap)
        info = dataclasses.replace(
            info, n_block_pairs=plan.total_syrk,
            plan_mismatch=info.plan_mismatch | ~plan.mirror_ok,
        )
    elif symmetric:
        # X^T == X: X itself is the transposed operand.  Truncating the
        # upper triangle and mirroring it is symmetric truncation, since
        # ||Y_ij|| == ||Y_ji|| for a symmetric iterate.
        yu, info = spgemm(x, x, accum=basic.triu(x), syrk_upper=True, **kw)
        y, sym_ovf = basic.symmetrize_upper(truncate(yu, tau), cap)
        info = dataclasses.replace(info, out_overflow=info.out_overflow | sym_ovf)
        nnz_kept = torch.where(sym_ovf, cap + 1, y.nnz)
    else:
        y, info = spgemm(x, x, accum=x, plan=plan, **kw)
        y, nnz_kept = truncate(y, tau, cap=cap)
    stats = PurificationStats(
        trace=t,
        nnz_blocks=y.nnz,
        n_block_pairs=info.n_block_pairs,
        pair_overflow=info.pair_overflow,
        # Undersized row caps also mean dropped output blocks.
        out_overflow=info.out_overflow | info.row_overflow,
        repack_overflow=nnz_kept > cap,
        nnz_union=info.n_out_blocks,
        plan_mismatch=info.plan_mismatch,
    )
    return y, stats


@dataclass(frozen=True)
class PurifyPlans:
    """Per-step symbolic+union plans of a fixed purification trajectory
    (every `SymbolicPlan` field stacked over a leading [n_steps] axis)
    and the expected per-step input ids.  Built by `plan_purify`; with
    them, `purify_scan` does no structural work per step.  A divergence
    from the planned trajectory is reported per step in
    `PurificationStats.plan_mismatch`, never silent."""

    plans: SymbolicPlan  # stacked: each field [n_steps, ...]
    expected_ids: torch.Tensor  # int32[n_steps, cap]

    @property
    def n_steps(self) -> int:
        return self.expected_ids.shape[0]

    def step(self, k: int) -> SymbolicPlan:
        """Step k's plan (views, no copy)."""
        return SymbolicPlan(**{
            f: None if v is None else v[k]
            for f, v in ((f, getattr(self.plans, f)) for f in _PLAN_FIELDS)
        })


def plan_purify(
    x: BlockMatrix,
    n_steps: int,
    tau,
    prof: "CapacityProfile",
    target_trace=0.0,
    backend: str = "auto",
    symmetric: bool = False,
) -> PurifyPlans:
    """Walk the SP2 trajectory once at `prof`'s capacities (bit-identical
    to the scan: same caps, same kernels) and capture each step's
    symbolic+union plan (with the mirror map when `symmetric`).  Reads
    the overflow flags on the host."""
    cap = prof.cap
    xi = repack_mod.repack(x, cap)
    plans, exp = [], []
    for k in range(n_steps):
        exp.append(xi.ids)
        plans.append(
            make_plan(xi, xi, prof.pair_cap, accum_ids=xi.ids, out_cap=prof.out_cap,
                      sym_mirror=symmetric)
        )
        xi, s = sp2_step(
            xi, tau, pair_cap=prof.pair_cap, out_cap=prof.out_cap,
            target_trace=target_trace, backend=backend, cap=cap,
            row_caps=prof.row_caps, plan=plans[-1], symmetric=symmetric,
        )
        if bool(s.pair_overflow | s.out_overflow | s.repack_overflow):
            raise RuntimeError(
                f"plan_purify: overflow at step {k}: the capacity profile "
                "does not cover this input (rebuild with profile_purify)"
            )
    stacked = SymbolicPlan(**{
        f: None if getattr(plans[0], f) is None
        else torch.stack([getattr(p, f) for p in plans])
        for f in _PLAN_FIELDS
    })
    return PurifyPlans(plans=stacked, expected_ids=torch.stack(exp))


def _stack_stats(stats: list) -> PurificationStats:
    return PurificationStats(**{
        f: torch.stack([getattr(s, f) for s in stats]) for f in _STAT_FIELDS
    })


def purify_scan(
    x: BlockMatrix,
    n_steps: int,
    tau,
    pair_cap: int,
    out_cap: int,
    target_trace=0.0,
    backend: str = "auto",
    cap: int | None = None,
    row_caps: tuple | None = None,
    symmetric: bool = False,
    plans: PurifyPlans | None = None,
):
    """`n_steps` SP2 iterations with no host round trip (the reference's
    `lax.scan`, here a Python loop of steps that never read the device).
    Returns (X_final, PurificationStats stacked [n_steps]).

    With `plans` (from `plan_purify`, same capacities), each step reuses
    its precomputed structure and runs only the numeric phase, the
    gather-add and the truncation (and, when `symmetric`, the mirror)."""
    cap = out_cap if cap is None else cap
    # The initial repack may drop input blocks: fold that into step 0's
    # repack_overflow so it is never silent.
    init_ovf = x.nnz > cap
    x = repack_mod.repack(x, cap)
    if plans is not None and tuple(plans.expected_ids.shape) != (n_steps, cap):
        raise ValueError(
            f"plans built for (n_steps, cap)={tuple(plans.expected_ids.shape)}, "
            f"got ({n_steps}, {cap})"
        )
    stats = []
    for k in range(n_steps):
        x, s = sp2_step(
            x, tau, pair_cap=pair_cap, out_cap=out_cap,
            target_trace=target_trace, backend=backend, cap=cap,
            row_caps=row_caps, symmetric=symmetric,
            plan=None if plans is None else plans.step(k),
        )
        stats.append(s)
    stats = _stack_stats(stats)
    ovf = stats.repack_overflow.clone()
    ovf[0] |= init_ovf
    return x, dataclasses.replace(stats, repack_overflow=ovf)


def purify(
    x: BlockMatrix,
    n_steps: int,
    tau,
    pair_cap: int,
    out_cap: int,
    target_trace=0.0,
    backend: str = "auto",
    cap: int | None = None,
    symmetric: bool = False,
):
    """Run `n_steps` SP2 iterations; `cap` is the iterate's capacity
    (default out_cap).  Returns (X_final, list[PurificationStats])."""
    cap = out_cap if cap is None else cap
    init_ovf = x.nnz > cap
    x = repack_mod.repack(x, cap)
    stats = []
    for _ in range(n_steps):
        x, s = sp2_step(
            x, tau, pair_cap=pair_cap, out_cap=out_cap,
            target_trace=target_trace, backend=backend, cap=cap,
            symmetric=symmetric,
        )
        stats.append(s)
    if stats:
        stats[0] = dataclasses.replace(
            stats[0], repack_overflow=stats[0].repack_overflow | init_ovf
        )
    return x, stats


class PurifyEngine:
    """SCF-regime runner: profile and plan once, reuse the planned scan
    across cycles, and re-profile/re-plan when the iterate's structure
    drifts off the planned trajectory or a capacity overflows.

        eng = PurifyEngine(n_steps=30, tau=1e-6, target_trace=n_occ)
        for cycle in range(...):
            D, stats = eng.run(F)

    `run` reads the device once per cycle (the drift/overflow check);
    replans are counted in `n_replans`.  `margin` loosens the profiled
    capacities so small support growth does not force a replan."""

    def __init__(
        self,
        n_steps: int,
        tau: float,
        target_trace: float = 0.0,
        backend: str = "auto",
        margin: float = 1.25,
        symmetric: bool = False,
    ):
        # symmetric=True runs the planned symmetric tier on the generic
        # capacity profile: its plans use the generic union and pairs.
        self.n_steps = n_steps
        self.tau = tau
        self.target_trace = target_trace
        self.backend = backend
        self.margin = margin
        self.symmetric = symmetric
        self.prof: CapacityProfile | None = None
        self.plans: PurifyPlans | None = None
        self.n_replans = 0

    def _replan(self, x: BlockMatrix) -> None:
        prof = profile_purify(
            x, self.n_steps, self.tau, target_trace=self.target_trace,
            backend=self.backend, margin=self.margin,
        )
        # Pow2-bucket the envelope so nearby structures share capacities.
        self.prof = dataclasses.replace(
            prof,
            pair_cap=_next_pow2(prof.pair_cap),
            out_cap=_next_pow2(prof.out_cap),
            cap=_next_pow2(prof.cap),
            row_caps=tuple(_next_pow2(r) for r in prof.row_caps),
        )
        self.plans = plan_purify(
            x, self.n_steps, self.tau, self.prof,
            target_trace=self.target_trace, backend=self.backend,
            symmetric=self.symmetric,
        )
        self.n_replans += 1

    @staticmethod
    def _bad(stats: PurificationStats) -> bool:
        return bool(torch.any(
            stats.plan_mismatch | stats.pair_overflow
            | stats.out_overflow | stats.repack_overflow
        ))

    def _stale(self, x: BlockMatrix) -> bool:
        """Compare the iterate's structure with the planned step-0 input
        before running, so a drifted input replans at once."""
        if int(x.nnz) > self.prof.cap:
            return True
        got = x.ids.cpu().numpy()
        exp = self.plans.expected_ids[0].cpu().numpy()
        got = got[got != SENTINEL]
        exp = exp[exp != SENTINEL]
        return got.shape != exp.shape or bool(np.any(got != exp))

    def run(self, x: BlockMatrix):
        """One purification at the cached plan; replans and reruns when the
        structure drifted.  Returns (X_final, stacked stats)."""
        if self.plans is None or self._stale(x):
            self._replan(x)
        kw = dict(
            target_trace=self.target_trace, backend=self.backend,
            plans=self.plans, symmetric=self.symmetric, **self.prof.kwargs(),
        )
        xf, stats = purify_scan(x, self.n_steps, self.tau, **kw)
        if self._bad(stats):
            self._replan(x)
            kw["plans"] = self.plans
            kw.update(self.prof.kwargs())
            xf, stats = purify_scan(x, self.n_steps, self.tau, **kw)
            if self._bad(stats):
                raise RuntimeError(
                    "PurifyEngine: overflow/mismatch persists after a fresh "
                    "replan: inspect stats/profile"
                )
        return xf, stats


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass(frozen=True)
class CapacityProfile:
    """Exact capacity needs of an SP2 purification run, measured by
    `profile_purify`; feed to ``purify_scan(x, n, tau, **prof.kwargs())``.
    The per-step tuples are the evidence (the densify-then-resparsify
    hump that a single-step plan misses)."""

    pair_cap: int
    out_cap: int
    cap: int
    row_caps: tuple  # (max B blocks per row, max C blocks per row)
    per_step_pairs: tuple
    per_step_out: tuple
    per_step_kept: tuple

    def kwargs(self) -> dict:
        """Keyword arguments for `purify_scan` / `sp2_step` / `purify`."""
        return dict(
            pair_cap=self.pair_cap, out_cap=self.out_cap, cap=self.cap,
            row_caps=self.row_caps,
        )


def profile_purify(
    x: BlockMatrix,
    n_steps: int,
    tau: float,
    target_trace=0.0,
    backend: str = "auto",
    symmetric: bool = False,
    margin: float = 1.0,
) -> CapacityProfile:
    """Dry-run `n_steps` SP2 iterations, host-planning each step's exact
    capacity needs, and return the tight maxima.  The trajectory is
    bit-identical to the final run: capacities only decide whether blocks
    are dropped, and the dry run's caps are exact host plans (pairs,
    rows) and sure bounds (out = product outputs + nnz), pow2-bucketed.
    `margin > 1` loosens the returned caps for nearby structures."""
    xi = x
    mbr_m = mcr_m = 1
    pairs_l, out_l, kept_l = [], [], []
    for k in range(n_steps):
        pc, oc, mbr, mcr = plan_spgemm_ex(xi, xi)
        pc, oc = max(pc, 1), max(oc, 1)
        mbr, mcr = max(mbr, 1), max(mcr, 1)
        run_pc = _next_pow2(pc)
        run_oc = _next_pow2(oc + int(xi.nnz))
        run_rc = (_next_pow2(mbr), _next_pow2(mcr))
        xi, s = sp2_step(
            xi, tau, pair_cap=run_pc, out_cap=run_oc,
            target_trace=target_trace, backend=backend, cap=run_oc,
            row_caps=run_rc, symmetric=symmetric,
        )
        if bool(s.pair_overflow | s.out_overflow | s.repack_overflow):
            raise RuntimeError(
                f"profile_purify: overflow at step {k} despite the exact host "
                f"plan (pair_cap={run_pc}, out_cap={run_oc}): planner and op "
                "disagree"
            )
        pairs_l.append(pc)
        out_l.append(int(s.nnz_union))
        kept_l.append(int(s.nnz_blocks))
        mbr_m, mcr_m = max(mbr_m, mbr), max(mcr_m, mcr)

    def grow(v):
        return int(np.ceil(v * margin))

    return CapacityProfile(
        pair_cap=grow(max(pairs_l)),
        out_cap=grow(max(out_l)),
        # The iterate capacity also holds the input (the scan's repack).
        cap=grow(max([int(x.nnz)] + kept_l)),
        row_caps=(grow(mbr_m), grow(mcr_m)),
        per_step_pairs=tuple(pairs_l),
        per_step_out=tuple(out_l),
        per_step_kept=tuple(kept_l),
    )
