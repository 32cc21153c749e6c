"""Plain reference of the product chain D = gamma * (alpha * A @ B + beta * A)
over random block-sparse A and B, and the inputs both sides get.

The reference works out everything the program derives: the product's
support from the two block masks, the pairs, D's block ids, and D's
values as one dense product at its mode's precision.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import counts, gen
from benchmark.reference import common


@dataclass
class Member:
    """One operand pair of the traffic's pool: sorted int64 block ids on
    the host, float32 [nnz, b, b] payloads on the device."""

    n: int
    b: int
    a_ids: np.ndarray
    a_data: torch.Tensor
    b_ids: np.ndarray
    b_data: torch.Tensor


def make_inputs(cfg: dict, pool: int, seed: int, device) -> list[Member]:
    """`pool` operand pairs of distinct structure, all payloads from one
    device call."""
    n, b, dens = cfg["n"], cfg["block_size"], cfg["block_density"]
    ids = [(gen.random_block_ids(n, b, dens, gen.host_rng(seed, m, 0)),
            gen.random_block_ids(n, b, dens, gen.host_rng(seed, m, 1))) for m in range(pool)]
    total = sum(a.size + bb.size for a, bb in ids)
    data = gen.normal_payloads(total, b, gen.device_generator(seed, 0, device), device)
    out, at = [], 0
    for a_ids, b_ids in ids:
        a_data = data[at:at + a_ids.size]
        at += a_ids.size
        b_data = data[at:at + b_ids.size]
        at += b_ids.size
        out.append(Member(n, b, a_ids, a_data, b_ids, b_data))
    return out


def structure(m: Member) -> dict:
    """Pairs, product blocks and D's block ids, from the masks alone."""
    nb = m.n // m.b
    ma, mb = counts.block_mask(m.a_ids, nb), counts.block_mask(m.b_ids, nb)
    prod = counts.product_mask(ma, mb)
    return dict(pairs=counts.pairs(ma, mb), out_blocks=int(prod.sum()),
                ids=counts.mask_ids(prod | ma))


def work(cfg: dict, m: Member, ref: dict) -> dict:
    """FLOPs of the call's products and its least bytes: A and B read
    once, D written once."""
    return dict(pairs=ref["pairs"], flops=counts.gemm_flops(ref["pairs"], m.b),
                bytes=counts.block_bytes(m.a_ids.size + m.b_ids.size + ref["ids"].size, m.b))


def reference(cfg: dict, m: Member, mode: str = "f64") -> dict:
    """D's ids and blocks, with the counters, at `mode`'s precision."""
    nb = m.n // m.b
    dt = common.work_dtype(mode)
    s = structure(m)
    a = common.dense(m.a_ids, m.a_data, nb, dt)
    bm = common.dense(m.b_ids, m.b_data, nb, dt)
    d = common.matmul(a, bm, mode)
    del bm
    d.mul_(cfg["alpha"]).add_(a, alpha=cfg["beta"]).mul_(cfg["gamma"])
    del a
    return dict(ids=s["ids"], data=common.blocks(d, s["ids"], nb),
                pairs=s["pairs"], out_blocks=s["out_blocks"])



def answer(ref: dict) -> dict:
    """A reference result read as an answer of the program (the control)."""
    return ref

def compare(got: dict, ref: dict) -> dict:
    """The numbers `correct` is decided on, for one answer."""
    d_err, ids_diff = common.compare_blocks(got["ids"], got["data"], ref["ids"], ref["data"])
    return dict(d_err=d_err, ids_diff=ids_diff,
                pairs_diff=abs(int(got["pairs"]) - ref["pairs"]),
                out_diff=abs(int(got["out_blocks"]) - ref["out_blocks"]))
