"""The system under test for SP2 purification: one SCF cycle's density
matrix from its Fock matrix F, on the port's public entry points.

A call is the Gershgorin bound of F on the device, X0 = (rho I - F) /
(2 rho) by one ``add`` with tensor factors, and ``PurifyEngine.run(X0)``:
``profile_purify`` + ``plan_purify`` in the warm-up's first call, then
the planned ``purify_scan`` (``spgemm(accum=, plan=)`` on the fine
kernel and ``truncate`` every step).  Only the ``"fixed"`` plan: the
engine keeps its plan while the structure holds.
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
            raise ValueError(f"sp2: unknown plan {traffic['plan']!r}")
        a = cfg["assumed"]
        self.fs = [matrix(m.ids, m.data, m.n, m.b) for m in members]
        m = members[0]
        self.eye = hbsm.eye(m.n, m.b, device=m.data.device)
        self.engines = [hbsm.PurifyEngine(a["n_steps"], a["tau"], target_trace=a["n_occ"])
                        for _ in members]

    def call(self, i: int):
        f, eng = self.fs[i % len(self.fs)], self.engines[i % len(self.engines)]
        rho = hbsm.gershgorin_bound(f)
        x0 = hbsm.add(self.eye, f, alpha=0.5, beta=-0.5 / rho)
        d, stats = eng.run(x0)
        return d, stats, eng

    @staticmethod
    def flags(out) -> list:
        """0-dim or [n_steps] bool tensors, any of them True when the call
        failed."""
        s = out[1]
        return [s.pair_overflow, s.out_overflow, s.repack_overflow, s.plan_mismatch]

    @staticmethod
    def export(out) -> dict:
        """D's valid ids and blocks, the steps' summed pairs, D's trace and
        the engine's replans after its first plan."""
        d, stats, eng = out
        nnz = int(d.nnz)
        return dict(ids=d.ids[:nnz].cpu().numpy().astype(np.int64), data=d.data[:nnz],
                    pairs=int(stats.n_block_pairs.sum(dtype=torch.int64)),
                    trace=float(hbsm.trace(d)), replans=eng.n_replans - 1)
