"""The system under test for the Loewdin factor: Z ~= S^-1/2 of one
geometry's overlap matrix S, on the port's public entry points.

A call is ``InvSqrtEngine.run(S)``: theta = ``gershgorin_bound(S)`` on the
device, ``profile_inv_sqrt`` + ``plan_inv_sqrt`` in the warm-up's first
call, then the planned ``inv_sqrt_newton_schulz`` (every step Z S,
(Z S) Z into T with the identity accumulated, Z T, all through
``spgemm(plan=)`` on the fine kernel, and ``truncate`` into the profiled
capacity).  Only the ``"fixed"`` plan: the engine keeps its plan while
S's structure holds.
"""

from __future__ import annotations

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from benchmark.systems.chain import matrix

PLANS = ("fixed",)


class Session:
    def __init__(self, cfg: dict, traffic: dict, members: list):
        if traffic["plan"] not in PLANS:
            raise ValueError(f"invsqrt: unknown plan {traffic['plan']!r}")
        a = cfg["assumed"]
        self.ss = [matrix(m.ids, m.data, m.n, m.b) for m in members]
        self.engines = [hbsm.InvSqrtEngine(a["n_steps"], a["tau"]) for _ in members]

    def call(self, i: int):
        eng = self.engines[i % len(self.engines)]
        z, pairs, ovf = eng.run(self.ss[i % len(self.ss)])
        return z, pairs, ovf, eng

    @staticmethod
    def flags(out) -> list:
        """The 0-dim overflow flag: any step's pair, output, row or
        iterate overflow, or a plan mismatch."""
        return [out[2]]

    @staticmethod
    def export(out) -> dict:
        """Z's valid ids and blocks, the steps' summed pairs and the
        engine's replans after its first plan."""
        z, pairs, _, eng = out
        nnz = int(z.nnz)
        return dict(ids=z.ids[:nnz].cpu().numpy().astype(np.int64), data=z.data[:nnz],
                    pairs=int(pairs.to(torch.int64)), replans=eng.n_replans - 1)
