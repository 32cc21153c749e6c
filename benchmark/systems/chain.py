"""The system under test for the product chain
D = gamma * (alpha * A @ B + beta * A): the port's calls, by where the
traffic finds the product's structure.

- ``"fixed"``: found once in set-up (the host plan ``plan_spgemm_ex`` and
  ``make_fine_plan``); a call is ``fine_matmul(plan=)`` -> ``fine_add`` ->
  ``fine_scale`` on the flat-resident operands.
- ``"host"``: found on the host every call, by the front door
  ``matmul`` -> ``add`` -> ``scale`` on the canonical operands.
"""

from __future__ import annotations

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

PLANS = ("fixed", "host")


def matrix(ids: np.ndarray, data: torch.Tensor, n: int, b: int) -> hbsm.BlockMatrix:
    """The port's matrix of the benchmark's sorted ids and payloads."""
    dev = data.device
    return hbsm.BlockMatrix(
        ids=torch.as_tensor(ids, dtype=torch.int32, device=dev), data=data.contiguous(),
        nnz=torch.tensor(ids.size, dtype=torch.int32, device=dev),
        n_rows=n, n_cols=n, block_size=b,
    )


class Session:
    def __init__(self, cfg: dict, traffic: dict, members: list):
        if traffic["plan"] not in PLANS:
            raise ValueError(f"chain: unknown plan {traffic['plan']!r}")
        self.cfg, self.plan = cfg, traffic["plan"]
        self.ops = []
        for m in members:
            a, b = matrix(m.a_ids, m.a_data, m.n, m.b), matrix(m.b_ids, m.b_data, m.n, m.b)
            if self.plan == "host":
                self.ops.append((a, b))
                continue
            pc, oc, mbr, mcr = plan_spgemm_ex(a, b)
            fplan = hbsm.make_fine_plan(a, b, pc, oc, (mbr, mcr))
            self.ops.append((hbsm.fine_pack(a), hbsm.fine_pack(b), (pc, oc, (mbr, mcr)), fplan))

    def call(self, i: int):
        cfg = self.cfg
        op = self.ops[i % len(self.ops)]
        if self.plan == "host":
            a, b = op
            c, info = hbsm.matmul(a, b, alpha=cfg["alpha"], precision=cfg["precision"])
            return hbsm.scale(hbsm.add(c, a, beta=cfg["beta"]), cfg["gamma"]), info
        af, bf, (pc, oc, caps), fplan = op
        c, info = hbsm.fine_matmul(af, bf, pc, oc, caps, alpha=cfg["alpha"],
                                   precision=cfg["precision"], plan=fplan)
        return hbsm.fine_scale(hbsm.fine_add(c, af, beta=cfg["beta"]), cfg["gamma"]), info

    @staticmethod
    def flags(out) -> list:
        """0-dim bool tensors, any of them True when the call failed."""
        info = out[1]
        return [info.pair_overflow, info.out_overflow, info.row_overflow, info.plan_mismatch]

    @staticmethod
    def export(out) -> dict:
        """D's valid ids and canonical blocks, and the product's counters."""
        d, info = out
        if isinstance(d, hbsm.FineFlat):
            d = hbsm.fine_unpack(d)
        nnz = int(d.nnz)
        return dict(ids=d.ids[:nnz].cpu().numpy().astype(np.int64), data=d.data[:nnz],
                    pairs=int(info.n_block_pairs), out_blocks=int(info.n_out_blocks))
