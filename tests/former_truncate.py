"""The truncation that the port's truncate kernels replaced on the card,
kept as the yardstick of their bits and of their device operations: the
block norms by torch reductions (or the norms kernel at b % 128 == 0 with
f32 or bf16 data), the keep mask, then a cumsum, an int scatter and a
gather.  Also the inputs both card files take.

Shared by `test_torch_norms_kernel.py`, `test_torch_truncate_card.py` and
chip_smoke.py's phase 25.  It imports no jax, so the card tests run
without the suite's conftest."""

import dataclasses

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL, BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import (
    block_frob_squared,
    squared_threshold,
    subtree_node_norms2,
)

BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    """`t` as integers of its width: equal bits, signed zeros included."""
    return t.view(BITS[t.dtype]) if t.is_floating_point() else t


def former_truncate(a, tau, subtree_level=None, cap=None):
    """`truncate(a, tau, subtree_level, cap)` as the port computed it
    before its truncate kernels."""
    tdt = torch.promote_types(a.dtype, torch.float32)
    if subtree_level is not None:
        keys, node_norms2 = subtree_node_norms2(a, subtree_level)
        keep = node_norms2[keys.long()] > squared_threshold(tau, tdt)
    elif pallas_norms.supported(a.block_size, a.dtype):
        _, keep = pallas_norms.norms_and_keep(a.data, tau)
    else:
        keep = block_frob_squared(a) > squared_threshold(tau, tdt)
    keep = keep & a.valid_mask()
    ocap = a.cap if cap is None else cap
    icap = a.cap
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, ocap).clamp_(max=ocap)
    src = torch.full((ocap + 1,), icap, dtype=torch.int64, device=a.device)
    src[slot] = torch.arange(icap, device=a.device)
    src = src[:ocap]
    pad = src == icap
    srcc = src.clamp(max=icap - 1)
    out_ids = torch.where(pad, SENTINEL, a.ids[srcc]).to(torch.int32)
    out_data = torch.where(pad[:, None, None], 0, a.data[srcc])
    kept = keep.sum().to(torch.int32)
    m = dataclasses.replace(a, ids=out_ids, data=out_data, nnz=torch.clamp(kept, max=ocap))
    return m if cap is None else (m, kept)


def assert_same_truncation(got, want):
    """Two results of `truncate`, with `cap` or without, bit for bit."""
    if isinstance(want, tuple):
        assert torch.equal(got[1], want[1]), (got[1], want[1])
        got, want = got[0], want[0]
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.nnz, want.nnz) and got.nnz.dtype == want.nnz.dtype
    assert got.data.shape == want.data.shape and got.data.dtype == want.data.dtype
    assert torch.equal(bits(got.data), bits(want.data))


def spread_matrix(cap, n_valid, b, nb, seed, device, dtype=torch.float32, decades=3.0):
    """`cap` slots of b x b blocks, `n_valid` sorted ids of an nb x nb grid
    then SENTINEL padding; N(0,1) blocks scaled by 10**(-decades * u), u
    uniform, so their norms spread over `decades` decades, each block's
    first entry -0.0 so signed zeros move through."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.full((cap,), SENTINEL, dtype=torch.int32, device=device)
    pick = torch.randperm(nb * nb, generator=gen, device=device)[:n_valid]
    ids[:n_valid] = pick.sort().values.to(torch.int32)
    data = torch.zeros((cap, b, b), dtype=dtype, device=device)
    scale = 10.0 ** (-decades * torch.rand((n_valid, 1, 1), generator=gen, device=device))
    data[:n_valid] = (torch.randn((n_valid, b, b), generator=gen, device=device) * scale).to(dtype)
    data.view(cap, -1)[:n_valid, 0] = -0.0
    return BlockMatrix(ids=ids, data=data, nnz=torch.tensor(n_valid, dtype=torch.int32,
                                                            device=device),
                       n_rows=nb * b, n_cols=nb * b, block_size=b)


def tau_keeping(a, share):
    """A threshold that keeps about `share` of the valid blocks: the norm at
    that quantile, from float64 sums."""
    n2 = a.data.double().square().sum(dim=(1, 2))[a.ids != SENTINEL]
    return float(torch.quantile(n2.sqrt().cpu(), 1.0 - share))


def sp2_step_matrix(device, seed=0, dtype=torch.float32):
    """The b3_sp2.planned step's product at its capacities: 262 144 slots of
    32 x 32, 172 000 valid on an 832 x 832 grid, and a threshold that keeps
    ~24 000 of them (the iterate's capacity is 65 536)."""
    a = spread_matrix(262_144, 172_000, 32, 832, seed, device, dtype)
    return a, tau_keeping(a, 24_000 / 172_000)
