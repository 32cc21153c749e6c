"""The fine kernel's launch schedule (kernels/pallas_gemm_fine.py
`slot_chunks`, `fine_tables`): its chunk table against one derived with
numpy from the JAX package's plan, and the kernel's walk over it (chunks
of a C row's slots, teams of slots, k-chunks of the row's A entries,
ballots of 32 entries, the B row cap) against the plain version's pair
list, `expand_pairs`/`pair_slots`."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf

from torch_port_helpers import SENTINEL, matrix_pair, np_

# (A grid, B grid, density, seed, A's empty rows, b_row_max or None for
# the plan's, slots past the product support): a small rectangular
# product with empty rows; a dense one whose A rows outgrow a k-chunk of
# 3, whose C rows outgrow a chunk, and whose B rows outgrow a row cap of 8.
STRUCTURES = {
    "sparse": ((8, 12), (12, 6), 0.3, 41, (1, 5), None, 5),
    "dense": ((6, 20), (20, 30), 0.6, 42, (2,), 1, 3),
}


def structure(name):
    """(a_ids, b_ids, out_ids, nbr, nbrB, nbc, b_row_max, JAX plan), from
    the JAX package's plan of the structure."""
    (nbr, nbrB), (_, nbc), density, seed, empty, brm, extra = STRUCTURES[name]
    ja, _ = matrix_pair(nbr, nbrB, 16, density, seed, empty_rows=empty, pad=2)
    jb, _ = matrix_pair(nbrB, nbc, 16, density, seed + 1)
    pc, oc, mbr, mcr = plan_spgemm_ex(ja, jb)
    plan = jx.make_fine_plan(ja, jb, pc, oc + extra, (mbr, mcr))
    brm = mbr if brm is None else brm
    ids = (np.array(np_(m)) for m in (ja.ids, jb.ids, plan.out_ids))
    return (*ids, nbr, nbrB, nbc, brm, plan)


def numpy_chunks(out_ids, nbr, nbc, chunk_slots, window=None):
    """Chunk bounds [2, n]: window by window (`window` block columns),
    each row's slots there in runs of chunk_slots, then the SENTINEL
    tail's, then empty chunks up to the table's fixed length."""
    out_cap = out_ids.size
    window = min(nbc if window is None else window, pf.SPAN)
    n_win = -(-nbc // window)
    valid = out_ids != SENTINEL
    pieces = [np.flatnonzero(valid & (out_ids // nbc == r) & (out_ids % nbc // window == w))
              for w in range(n_win) for r in range(nbr)]
    chunks = []
    for idx in pieces + [np.flatnonzero(~valid)]:
        if idx.size:
            assert np.all(np.diff(idx) == 1)  # a piece is a run of slots
            end = idx[-1] + 1
            chunks += [(st, min(st + chunk_slots, end)) for st in range(idx[0], end, chunk_slots)]
    n = nbr * n_win + 1 + -(-out_cap // chunk_slots)
    assert len(chunks) <= n
    chunks += [(0, 0)] * (n - len(chunks))
    return np.array(chunks, np.int32).T


@pytest.mark.parametrize("name", sorted(STRUCTURES))
@pytest.mark.parametrize("chunk_slots", [1, 3, 7, 128])
@pytest.mark.parametrize("window", [None, 5])
def test_slot_chunks_match_numpy(name, chunk_slots, window):
    _, _, out_ids, nbr, _, nbc, _, plan = structure(name)
    c_row_start = torch.from_numpy(np.array(plan.tables[4]))
    got = pf.slot_chunks(torch.from_numpy(out_ids), c_row_start, nbc, chunk_slots, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  numpy_chunks(out_ids, nbr, nbc, chunk_slots, window))


def test_slot_chunks_span_at_most_span_columns():
    # One C row of 600 columns and a tail: windows of SPAN = 256 columns.
    out_ids = np.concatenate([np.arange(600), [SENTINEL] * 3]).astype(np.int32)
    c_row_start = torch.tensor([0, 600], dtype=torch.int32)
    got = pf.slot_chunks(torch.from_numpy(out_ids), c_row_start, 600, chunk_slots=1000)
    assert got[:, :4].tolist() == [[0, 256, 512, 600], [256, 512, 600, 603]]
    assert not got[:, 4:].any()
    np.testing.assert_array_equal(got.numpy(), numpy_chunks(out_ids, 1, 600, 1000))


def test_col_window_keeps_a_windows_b_blocks_in_l2():
    # B2 (13 107 blocks of 32x32, f32: 53.7 MB): four windows of 128 columns.
    assert pf.col_window(512, 13107, 32) == 128
    assert pf.col_window(512, 100, 32) == 512  # small B: one window
    assert pf.col_window(30, 13107, 64) == 3  # 215 MB: 13 windows, 3 columns each
    assert 13107 * 32 * 32 * 4 / 4 <= pf.B_PANEL_BYTES


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_fine_plan_tables_extend_jax_tables(name):
    a_ids, b_ids, out_ids, nbr, nbrB, nbc, _, plan = structure(name)
    tables = pf.fine_tables(*(torch.from_numpy(x) for x in (a_ids, b_ids, out_ids)),
                            nbr, nbrB, nbc, 16)
    assert len(tables) == 7 and len(plan.tables) == 6
    for got, want in zip(tables, plan.tables):
        np.testing.assert_array_equal(got.numpy(), np_(want))
    window = pf.col_window(nbc, b_ids.size, 16)
    np.testing.assert_array_equal(
        tables[6].numpy(), numpy_chunks(out_ids, nbr, nbc, pf.CHUNK_SLOTS, window))


def test_fine_plan_carries_the_chunk_table():
    ja, ta = matrix_pair(8, 8, 32, 0.3, 31, empty_rows=(3,), pad=2)
    pc, oc, mbr, mcr = plan_spgemm_ex(ja, ja)
    tplan = tx.make_fine_plan(ta, ta, pc, oc + 4, (mbr, mcr))
    jplan = jx.make_fine_plan(ja, ja, pc, oc + 4, (mbr, mcr))
    for got, want in zip(tplan.tables, jplan.tables):
        np.testing.assert_array_equal(np_(got), np_(want))
    np.testing.assert_array_equal(
        np_(tplan.tables[6]), numpy_chunks(np_(jplan.out_ids), 8, 8, pf.CHUNK_SLOTS))


def kernel_walk(a_ids, b_ids, out_ids, nbrB, nbc, b_row_max, chunks, kc):
    """The kernel's visiting order, in numpy: slot -> [(A entry, B entry)]
    in the order its team accumulates them.  Teams take a chunk's slots
    from a counter, and which team takes one does not change its sums, so
    the slots are walked in order here."""
    brm = max(-(-max(b_row_max, 1) // 8) * 8, 8)
    a_ok, b_ok = a_ids != SENTINEL, b_ids != SENTINEL
    pairs = {}
    for c in range(chunks.shape[1]):
        s0, s1 = int(chunks[0, c]), int(chunks[1, c])
        if s0 >= s1 or out_ids[s0] == SENTINEL:
            continue
        i = out_ids[s0] // nbc
        assert np.all(out_ids[s0:s1] // nbc == i)  # a chunk stays in its row
        row = np.flatnonzero(a_ok & (a_ids // nbrB == i))
        for k0 in range(0, max(row.size, 1), kc):
            entries = row[k0:k0 + kc]
            for s in range(s0, s1):
                j = out_ids[s] % nbc
                got = pairs.setdefault(s, [])
                for g in range(0, entries.size, 32):  # one ballot each
                    for e in entries[g:g + 32]:
                        k = a_ids[e] % nbrB
                        brow = np.flatnonzero(b_ok & (b_ids // nbc == k))[:brm]
                        got += [(int(e), int(q)) for q in brow if b_ids[q] % nbc == j]
    return pairs


@pytest.mark.parametrize("name", sorted(STRUCTURES))
@pytest.mark.parametrize("kc, chunk_slots, window", [
    (64, pf.CHUNK_SLOTS, None),  # rows in one k-chunk, one window
    (3, 5, 4),                   # k-chunks of 3, windows of 4 columns
    (3, 1, None),                # one slot per chunk
])
def test_walk_gives_the_plain_versions_pairs(name, kc, chunk_slots, window):
    a_ids, b_ids, out_ids, nbr, nbrB, nbc, brm, plan = structure(name)
    chunks = pf.slot_chunks(torch.from_numpy(out_ids), torch.from_numpy(np.array(plan.tables[4])),
                            nbc, chunk_slots, window).numpy()
    walk = kernel_walk(a_ids, b_ids, out_ids, nbrB, nbc, brm, chunks, kc)
    n_used = int(np.sum(out_ids != SENTINEL))
    assert sorted(walk) == list(range(n_used))  # every used slot, once each

    t = [torch.from_numpy(x) for x in (a_ids, b_ids, out_ids)]
    a_col, b_row_start, b_col = pf.build_tables(*t, nbr, nbrB, nbc)[1:4]
    a_idx, b_idx = pf.expand_pairs(t[0], a_col, b_row_start, brm)
    c_id = (t[0][a_idx].long() // nbrB) * nbc + b_col[b_idx].long()
    slot = pf.pair_slots(t[2], c_id.to(torch.int32), out_ids.size)
    want = {}
    for s, e, q in zip(slot.tolist(), a_idx.tolist(), b_idx.tolist()):
        if s < out_ids.size:
            want.setdefault(s, []).append((e, q))
    for s in range(n_used):
        assert walk[s] == sorted(want.get(s, [])), s  # ascending A entry
    assert sum(map(len, walk.values())) > n_used  # slots with several products
    if name == "dense":  # several k-chunks where kc = 3; the row cap truncates
        assert np.bincount(a_ids[a_ids != SENTINEL] // nbrB).max() > 3
        assert np.bincount(b_ids // nbc).max() > 8


def test_slot_chunks_read_nothing_on_the_host(monkeypatch):
    """Built from device tensors alone: no value reaches the host, and the
    table's shape depends only on nbr, the windows and out_cap."""
    _, _, out_ids, nbr, _, nbc, _, plan = structure("sparse")
    ids = torch.from_numpy(out_ids)
    c_row_start = torch.from_numpy(np.array(plan.tables[4]))
    tail_ids = torch.full_like(ids, int(SENTINEL))  # every slot in the tail
    tail_start = torch.zeros_like(c_row_start)

    def refuse(*args, **kwargs):
        raise AssertionError("host read")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = pf.slot_chunks(ids, c_row_start, nbc, 4, 2)
    tail = pf.slot_chunks(tail_ids, tail_start, nbc, 4, 2)
    monkeypatch.undo()
    n = nbr * 3 + 1 + -(-ids.shape[0] // 4)  # three windows of 2 columns
    assert got.shape == tail.shape == (2, n)
    starts = list(range(0, ids.shape[0], 4))
    assert tail[0].tolist() == starts + [0] * (n - len(starts))
    np.testing.assert_array_equal(got.numpy(), numpy_chunks(out_ids, nbr, nbc, 4, 2))
