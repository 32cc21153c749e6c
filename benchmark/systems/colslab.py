"""The system under test for the near-dense product C = A @ B: the port's
column-slab tier.

- ``"fixed"``: the structure is found once in set-up (``plan_colslab``
  over the configuration's ``n_slabs``); a call is
  ``spgemm_colslab(A, B, plan=)``, each slab one exactly planned
  ``spgemm`` on the row-panel kernel.

The answer is a `BlockMatrix` and a `MultiplyInfo`, as the chain's front
door returns, so the chain's `flags` and `export` read it.
"""

from __future__ import annotations

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from benchmark.systems import chain
from hierarchical_block_sparse_lib_tpu_torch.ops.slab import plan_colslab

PLANS = ("fixed",)


class Session(chain.Session):
    def __init__(self, cfg: dict, traffic: dict, members: list):
        if traffic["plan"] not in PLANS:
            raise ValueError(f"colslab: unknown plan {traffic['plan']!r}")
        self.cfg = cfg
        self.ops = []
        for m in members:
            a = chain.matrix(m.a_ids, m.a_data, m.n, m.b)
            b = chain.matrix(m.b_ids, m.b_data, m.n, m.b)
            self.ops.append((a, b, plan_colslab(a, b, cfg["n_slabs"])))

    def call(self, i: int):
        a, b, plan = self.ops[i % len(self.ops)]
        return hbsm.spgemm_colslab(a, b, plan=plan, precision=self.cfg["precision"])
