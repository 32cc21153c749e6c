"""The fine kernel's "highest" product (kernels/csrc/gemm_fine.cu, 3xTF32
on mma.sync) on the card, at b = 16, 32 and 64, on one product that holds
the kernel's edges:

- an A row of 80 entries, more than one k-chunk at every leaf, so a slot's
  sums cross k-chunks through the output;
- B rows dense over the output columns, as T is in Newton-Schulz, and a
  chunk of slots whose columns span the whole 256-column bitmap;
- output slots that no product reaches, an empty C row's slots and a tail
  of SENTINEL slots, all zero.

Held against a float64 oracle (1e-5 of the largest element) and the plain
version (`fine_spgemm_reference`, within chip_smoke.py's `TOL` of the
largest element, as chip_smoke.py holds the kernel's edges); two launches
of one plan bitwise equal; in each shape `launch_shape` picks, no spill
and at least the blocks per SM its shared memory is sized for; at b = 32
the narrow shape (`NARROW`) bitwise equal to the wide one.

Needs a CUDA card (marker `card`; each test skips without one).  On a
machine with one, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fine_kernel_card.py
"""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

from chip_smoke import TOL, rel_err

pytestmark = pytest.mark.card

LEAVES = (16, 32, 64)
NBR, NBRB, NBC = 4, 80, 256
ALPHA = -0.5
# Row 0's slots: every other column, then the last, so that one chunk of
# CHUNK_SLOTS slots spans columns 0..255.
ROW0_COLS = list(range(0, 254, 2)) + [255]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fine kernel runs only there")
    return torch.device("cuda")


def blocks(ids, nbr, nbc, b, rng, device):
    ids = np.asarray(ids, dtype=np.int32)
    data = rng.standard_normal((ids.size, b, b)).astype(np.float32)
    return tx.BlockMatrix(
        ids=torch.from_numpy(ids).to(device), data=torch.from_numpy(data).to(device),
        nnz=torch.tensor(ids.size, dtype=torch.int32, device=device),
        n_rows=nbr * b, n_cols=nbc * b, block_size=b,
    )


_CASES = {}


def case(b, device):
    """(A, B, out_ids, tables, b_row_max, valid slots) of the edge product."""
    if b in _CASES:
        return _CASES[b]
    rng = np.random.default_rng(1000 + b)
    b_ids = [k * NBC + j for k in range(16) for j in range(NBC)]  # dense B rows
    sparse = rng.choice((NBRB - 16) * NBC, (NBRB - 16) * NBC // 20, replace=False) + 16 * NBC
    b_ids = np.sort(np.concatenate([b_ids, sparse]))
    b_ids = b_ids[b_ids // NBC < 70]  # B rows 70..79 empty
    a_ids = list(range(NBRB)) + [2 * NBRB + 3, 2 * NBRB + 40] \
        + [3 * NBRB + k for k in (72, 75)]
    A = blocks(a_ids, NBR, NBRB, b, rng, device)
    B = blocks(b_ids, NBRB, NBC, b, rng, device)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, B)
    support = tx.make_fine_plan(A, B, pc, oc, (mbr, mcr)).out_ids[:oc].cpu().numpy()
    row2 = support[support // NBC == 2]
    ids = [c for c in ROW0_COLS] + [NBC + 3, NBC + 50] + list(row2) + [3 * NBC + 7]
    used = torch.tensor(sorted(ids), dtype=torch.int32, device=device)
    out_ids = torch.cat([used, torch.full((5,), tx.SENTINEL, dtype=torch.int32, device=device)])
    # One column window (a plan's would cut these columns by the size of B),
    # so that a chunk of row 0 spans all 256 columns.
    rows = pf.build_tables(A.ids, B.ids, out_ids, NBR, NBRB, NBC)
    tables = rows + (pf.slot_chunks(out_ids, rows[4], NBC),)
    _CASES[b] = (A, B, out_ids, tables, mbr, used.shape[0])
    return _CASES[b]


def run(b, device, fn=pf.fine_spgemm):
    A, B, out_ids, tables, mbr, _ = case(b, device)
    return fn(A.ids, A.data, B.ids, B.data, out_ids, NBR, NBRB, NBC, out_ids.shape[0], mbr, NBC,
              precision="highest", block_size=b, out_layout="canonical", alpha=ALPHA,
              tables=tables)


@pytest.mark.parametrize("b", LEAVES)
def test_case_holds_the_edges(card, b):
    A, B, out_ids, tables, mbr, n_used = case(b, card)
    shape = pf.launch_shape(b, "highest", out_ids.shape[0], NBR, NBC, B.ids.shape[0])
    kc = pf.launch_config(b, "highest", mbr, shape)["kc"]
    assert kc < NBRB, f"k-chunk {kc} holds A's row 0 whole"
    ccol, chunks = tables[5], tables[6].cpu()
    spans = [int(ccol[s1 - 1] - ccol[s0]) for s0, s1 in chunks.T.tolist() if s1 > s0
             and int(out_ids[s0]) != tx.SENTINEL]
    assert max(spans) == pf.SPAN - 1
    assert mbr >= NBC  # the dense B rows seen whole


@pytest.mark.parametrize("b", LEAVES)
def test_highest_against_f64_and_plain(card, b):
    A, B, out_ids, _, _, n_used = case(b, card)
    got = run(b, card)
    plain = run(b, card, pf.fine_spgemm_reference)
    torch.cuda.synchronize()
    # As chip_smoke.py holds the kernel's edges to its plain version: up to
    # ~20 products of b-deep sums a slot, relative to the largest element.
    err_plain = rel_err(got, plain)
    assert err_plain <= TOL["highest"], f"b={b}: {err_plain:.3e} from the plain version"
    dense = ALPHA * (tx.to_dense(A).double() @ tx.to_dense(B).double())
    grid = dense.view(NBR, b, NBC, b).permute(0, 2, 1, 3)
    ids = out_ids[:n_used].long()
    want = grid[ids // NBC, ids % NBC]
    err = float((got[:n_used].double() - want).abs().max() / want.abs().max())
    assert err <= 1e-5, f"b={b}: {err:.3e} of the largest element from the f64 oracle"


@pytest.mark.parametrize("b", LEAVES)
def test_fixed_plan_bitwise(card, b):
    first, second = run(b, card), run(b, card)
    assert torch.equal(first, second)


@pytest.mark.parametrize("b", LEAVES)
def test_slots_without_products_are_zero(card, b):
    _, _, out_ids, _, _, n_used = case(b, card)
    got = run(b, card)
    ids = out_ids[:n_used]
    idle = (ids // NBC == 1) | (ids // NBC == 3)  # row 1 empty; row 3's B rows empty
    assert int(idle.sum()) == 3
    assert torch.count_nonzero(got[:n_used][idle]) == 0
    assert torch.count_nonzero(got[n_used:]) == 0  # the SENTINEL tail
    assert torch.count_nonzero(got[:n_used][~idle].flatten(1), dim=1).min() > 0


@pytest.mark.parametrize("b", LEAVES)
def test_launch_config(card, b):
    for threads, ctas in pf.shapes(b, "highest"):
        cfg = pf.launch_config(b, "highest", 44, (threads, ctas))
        assert cfg["local_bytes"] == 0, cfg
        assert cfg["blocks_per_sm"] >= ctas, cfg
        assert cfg["threads"] == threads, cfg


def test_narrow_shape_at_b32_equals_the_wide_bitwise(card):
    """The narrow shape (NARROW: blocks of 128 threads, three an SM, a
    k-chunk of 10 entries) sums each slot as the wide one does."""
    A, B, out_ids, tables, mbr, _ = case(32, card)
    _, _, prec, at, bt = pf._operands(A.data, B.data, 32, "highest", ALPHA)
    wide, narrow = pf.shapes(32, "highest")
    assert pf.launch_config(32, "highest", mbr, narrow)["kc"] < NBRB
    got = {shape: pf.launch(out_ids, tables, at, bt, out_ids.shape[0], NBR, NBC, mbr, prec,
                            shape=shape) for shape in (narrow, wide)}
    assert torch.equal(got[narrow], got[wide])
