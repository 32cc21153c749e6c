"""The output of spgemm's fine branch as the port made it before its output
pass (`kernels/fine_epilogue.py`), kept as the yardstick of that pass's
bits: the fine kernel's product in canonical layout (`fine_spgemm(...,
out_layout="canonical")`, whose `_output` transposes C^T), the ×alpha
`where` pass over the union's slots, the accumulator's blocks gathered
into the union (`gather_slots`), the ×beta pass and the add.  Also the
cases both test files take.

Shared by `test_torch_fine_epilogue.py`, `test_torch_fine_epilogue_card.py`
and chip_smoke.py's phase 24.  It imports no jax, so the card tests run
without the suite's conftest."""

import torch

from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    SENTINEL,
    BlockMatrix,
    scalar_factor,
)
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import alpha_is_one_static

BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64}


def bits(t: torch.Tensor) -> torch.Tensor:
    """`t` as integers of its width: equal bits, signed zeros included."""
    return t.view(BITS[t.dtype]) if t.is_floating_point() else t


def former_output(c, out_ids, alpha=1.0, acc_data=None, pos_acc=None, beta=1.0,
                  dtype=torch.float32):
    """D from the canonical product blocks `c` [out_cap, b, b] (f32), the
    union's ids `out_ids` and the accumulator's blocks landing in the union
    slots `pos_acc`, as spgemm's fine branch computed it."""
    out_cap = c.shape[0]
    if not (alpha_is_one_static(alpha) and dtype == c.dtype):
        slot_valid = out_ids != SENTINEL
        c = torch.where(slot_valid[:, None, None], c * scalar_factor(alpha, c), 0).to(dtype)
    if acc_data is None:
        return c
    acc_dtype = torch.promote_types(dtype, torch.float32)
    acc_blocks = basic.gather_slots(pos_acc, acc_data, out_cap)
    c = c.to(acc_dtype)
    return (c + scalar_factor(beta, c) * acc_blocks.to(acc_dtype)).to(dtype)


def union_slots_of(out_ids, acc_ids):
    """Each accumulator row's slot in the union ids `out_ids` (`out_cap`
    where it has none: a SENTINEL row or an id the union dropped)."""
    out_cap = out_ids.shape[0]
    if out_cap == 0:
        return torch.zeros_like(acc_ids)
    p = torch.searchsorted(out_ids, acc_ids).clamp(max=out_cap - 1)
    hit = (out_ids[p] == acc_ids) & (acc_ids != SENTINEL)
    return torch.where(hit, p, out_cap).to(torch.int32)


def former_fine_spgemm(a, b, out_ids, row_caps, alpha=1.0, beta=1.0, accum=None,
                       precision="highest"):
    """spgemm(backend="fine")'s data as the port computed it before the
    output pass, for the union ids `out_ids` that spgemm returned."""
    out_cap = out_ids.shape[0]
    c = pallas_gemm_fine.fine_spgemm(
        a.ids, a.data, b.ids, b.data, out_ids, a.nb_rows, b.nb_rows, b.nb_cols, out_cap,
        row_caps[0], row_caps[1], precision=precision, out_layout="canonical",
    )
    if accum is None:
        return former_output(c, out_ids, alpha, dtype=a.dtype)
    return former_output(c, out_ids, alpha, accum.data, union_slots_of(out_ids, accum.ids),
                         beta, dtype=a.dtype)


NB = 6  # block rows and columns of the cases' grid

# name: an accumulator's support against the product's
ACCUMS = ("none", "disjoint", "overlap", "equal", "empty")


def _matrix(ids, pad, b, gen, device):
    """N(0,1) blocks at the sorted `ids`, `pad` SENTINEL slots after them;
    each block's first entry -0.0, so signed zeros reach the sums."""
    ids = sorted(int(i) for i in ids)
    n = len(ids)
    data = torch.zeros((n + pad, b, b))
    data[:n] = torch.randn((n, b, b), generator=gen)
    data.view(n + pad, -1)[:n, 0] = -0.0
    return BlockMatrix(
        ids=torch.tensor(ids + [SENTINEL] * pad, dtype=torch.int32, device=device),
        data=data.to(device), nnz=torch.tensor(n, dtype=torch.int32, device=device),
        n_rows=NB * b, n_cols=NB * b, block_size=b,
    )


def fine_case(b, accum, seed, device):
    """(A, B, the accumulator or None, pair_cap, out_cap, row_caps) on an
    NB x NB grid of b x b blocks: A and B a third full, an accumulator whose
    support is disjoint from the product's, overlaps it or equals it, and a
    union with SENTINEL slots after it; "empty" has no A blocks and an
    accumulator of padding only, so the union is empty."""
    gen = torch.Generator().manual_seed(seed)
    grid = NB * NB
    a_ids = [] if accum == "empty" else torch.randperm(grid, generator=gen)[:12].tolist()
    b_ids = torch.randperm(grid, generator=gen)[:12].tolist()
    a, bm = _matrix(a_ids, 2, b, gen, device), _matrix(b_ids, 1, b, gen, device)
    occ_a = torch.zeros((NB, NB))
    occ_b = torch.zeros((NB, NB))
    for occ, ids in ((occ_a, a_ids), (occ_b, b_ids)):
        for i in ids:
            occ[i // NB, i % NB] = 1
    prod = (occ_a @ occ_b).flatten()
    support = torch.nonzero(prod).flatten().tolist()
    pairs = int(prod.sum())
    rest = [i for i in range(grid) if i not in set(support)]
    perm = torch.randperm(len(rest), generator=gen).tolist()
    acc_ids = {
        "none": None,
        "disjoint": [rest[i] for i in perm[:7]],
        "overlap": support[::2] + [rest[i] for i in perm[:5]],
        "equal": support,
        "empty": [],
    }[accum]
    acc = None if acc_ids is None else _matrix(acc_ids, 3, b, gen, device)
    union = len(set(support) | set(acc_ids or []))
    max_b_row = int(occ_b.sum(1).max())
    max_c_row = NB
    return a, bm, acc, max(pairs, 1) + 3, union + 4, (max_b_row, max_c_row)


def sp2_step_operands(device, seed=0, out_cap=262_144, n_valid=172_000, n_acc=26_600,
                      acc_cap=65_536, b=32, nb=832):
    """The b3_sp2.planned step's output at its capacities: `out_cap` union
    slots of b x b blocks, `n_valid` ids of an nb x nb grid then SENTINEL;
    C^T blocks with zeros in the tail and -0.0 first entries; an
    accumulator of `n_acc` blocks of the union (capacity `acc_cap`) and its
    rows' union slots."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pick = torch.randperm(nb * nb, generator=gen, device=device)[:n_valid]
    ids = torch.full((out_cap,), SENTINEL, dtype=torch.int32, device=device)
    ids[:n_valid] = pick.sort().values.to(torch.int32)
    ct = torch.randn((out_cap, b, b), generator=gen, device=device)
    ct[n_valid:] = 0.0
    ct.view(out_cap, -1)[:n_valid, 0] = -0.0
    rows = torch.randperm(n_valid, generator=gen, device=device)[:n_acc].sort().values
    acc_ids = torch.full((acc_cap,), SENTINEL, dtype=torch.int32, device=device)
    acc_ids[:n_acc] = ids[rows]
    acc = torch.zeros((acc_cap, b, b), device=device)
    acc[:n_acc] = torch.randn((n_acc, b, b), generator=gen, device=device)
    return ct, ids, acc, union_slots_of(ids, acc_ids)
