"""What the planned model drivers share (`models.purification.PurifyEngine`
for SP2, `models.inverse_factor.InvSqrtEngine` for Newton-Schulz): the
capacity profile of an iteration's run, its power-of-two rounding, the
host check of a structure against a plan, and the engine loop that
profiles, plans, checks and replans.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL, BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import span


def next_pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


@dataclass(frozen=True)
class CapacityProfile:
    """Exact capacity needs of an iteration's run, measured by
    `profile_purify` (SP2; feed to ``purify_scan(x, n, tau,
    **prof.kwargs())``) or `models.inverse_factor.profile_inv_sqrt`
    (Newton-Schulz; one entry per step holds its three products' needs).
    The per-step tuples are the evidence (the densify-then-resparsify
    hump that a single-step plan misses)."""

    pair_cap: int
    out_cap: int
    cap: int
    row_caps: tuple  # (max B blocks per row, max C blocks per row)
    per_step_pairs: tuple
    per_step_out: tuple
    per_step_kept: tuple

    def pow2(self) -> "CapacityProfile":
        """Every capacity rounded up to the next power of two."""
        return dataclasses.replace(
            self,
            pair_cap=next_pow2(self.pair_cap),
            out_cap=next_pow2(self.out_cap),
            cap=next_pow2(self.cap),
            row_caps=tuple(next_pow2(r) for r in self.row_caps),
        )

    def kwargs(self) -> dict:
        """Keyword arguments for `purify_scan` / `sp2_step` / `purify` /
        `inv_sqrt_newton_schulz`."""
        return dict(
            pair_cap=self.pair_cap, out_cap=self.out_cap, cap=self.cap,
            row_caps=self.row_caps,
        )


def ids_differ(got: torch.Tensor, exp: torch.Tensor) -> bool:
    """True when two sorted id arrays hold other valid ids (SENTINEL
    padding aside): one host read of each."""
    got, exp = got.cpu().numpy(), exp.cpu().numpy()
    got = got[got != SENTINEL]
    exp = exp[exp != SENTINEL]
    return got.shape != exp.shape or bool(np.any(got != exp))


class PlannedEngine:
    """The SCF-regime runner's loop: profile, round every capacity up to
    a power of two and plan in the first `run`; replan before running
    when the input's structure left the plan (`_stale`), and once more,
    then rerun, when a planned run reports an overflow or a plan mismatch
    (`_failed`); raise when that persists.  Replans are counted in
    `n_replans`.  A subclass names its entry span (`SPAN`) and gives
    `_profile`, `_plan`, `_run_planned`, `_failed` and `_stale`."""

    SPAN = ""

    def __init__(self):
        self.prof: CapacityProfile | None = None
        self.plans = None
        self.n_replans = 0

    def _replan(self, x: BlockMatrix) -> None:
        with span("hbsm.replan"):
            # Pow2-bucket the envelope so nearby structures share capacities.
            self.prof = self._profile(x).pow2()
            self.plans = self._plan(x)
            self.n_replans += 1

    def _bad(self, out) -> bool:
        with span("hbsm.engine_check"):
            return bool(torch.any(self._failed(out)))

    def run(self, x: BlockMatrix):
        """One run at the cached plan; replans and reruns when the
        structure drifted or a capacity overflowed."""
        with span(self.SPAN):
            if self.plans is None or self._stale(x):
                self._replan(x)
            out = self._run_planned(x)
            if self._bad(out):
                self._replan(x)
                out = self._run_planned(x)
                if self._bad(out):
                    raise RuntimeError(
                        f"{type(self).__name__}: overflow/mismatch persists after a "
                        "fresh replan: inspect stats/profile"
                    )
            return out
