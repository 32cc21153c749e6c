"""The redesigned micro kernels' contracts on the CPU: `e3` depends only on
how many entries each slot has (the property its one-launch kernel rests
on), `e3` with every entry in one slot against the JAX kernel of
scripts/micro_fine_kernel2.py in interpret mode, "quad" as the same
function as "wide", the ctypes table against the C entries, and a model
of `e12`'s one-launch slot walk against the order the plain version's runs
give.

R3 is a global of the JAX script, read when `e3` traces; it is set to the
value test_torch_micro_fine2.py sets, since both files share the module.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf

from torch_port_helpers import import_jax_script, interpret_zero

jax_micro2 = import_jax_script("micro_fine_kernel2")
R3 = 64
jax_micro2.R3 = R3
N_SLOTS = mf.ACC_ROWS // 8
V = np.random.default_rng(6).standard_normal((8, 128)).astype(np.float32)


def count_oracle(idx, v):
    """Each slot p: v added count(p) times, serially in f32."""
    acc = np.zeros((N_SLOTS, 8, 128), np.float32)
    counts = np.bincount(idx[(idx >= 0) & (idx < N_SLOTS)], minlength=N_SLOTS)
    for p in np.nonzero(counts)[0]:
        for _ in range(counts[p]):
            acc[p] += v
    return acc.reshape(mf.ACC_ROWS, 128)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(-3, 12), max_size=80).flatmap(
    lambda xs: st.tuples(st.just(xs), st.permutations(range(len(xs))))))
def test_e3_reference_is_bitwise_invariant_under_permutation(case):
    """Every entry adds the same v, so a slot's value depends only on its
    count: any order of idx gives the same bits (the port's e3 kernel
    counts entries per slot in one launch, with no sort)."""
    xs, perm = case
    idx = np.asarray(xs, np.int32)
    v = torch.from_numpy(V)
    _, acc = mf.e3_reference(torch.from_numpy(idx), v)
    _, permuted = mf.e3_reference(torch.from_numpy(idx[list(perm)]), v)
    assert torch.equal(acc, permuted)
    np.testing.assert_array_equal(acc.numpy(), count_oracle(idx, V))


@pytest.mark.parametrize("slot", [0, 511])
def test_e3_all_entries_in_one_slot_match_jax_exactly(slot):
    idx = np.full(R3, slot, np.int32)
    with interpret_zero():
        want = np.asarray(jax_micro2.e3(idx, V))
    out, acc = mf.e3(torch.from_numpy(idx), torch.from_numpy(V))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(acc.numpy(), count_oracle(idx, V))
    assert np.count_nonzero(acc.numpy().reshape(N_SLOTS, 1024).any(axis=1)) == 1


def test_e3_4096_entries_in_one_slot_and_none():
    idx = np.full(4096, 3, np.int32)
    _, acc = mf.e3(torch.from_numpy(idx), torch.from_numpy(V))
    np.testing.assert_array_equal(acc.numpy(), count_oracle(idx, V))
    _, empty = mf.e3(torch.zeros(0, dtype=torch.int32), torch.from_numpy(V))
    assert empty.shape == (mf.ACC_ROWS, 128) and not empty.any()


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_micro_reference_quad_equals_wide_bitwise(precision):
    rng = np.random.default_rng(7)
    at = torch.from_numpy((rng.standard_normal((32, 256)) * 0.1).astype(np.float32))
    bp = torch.from_numpy((rng.standard_normal((32, 384)) * 0.1).astype(np.float32))
    wide = mf.micro_reference(at, bp, "wide", precision, reps=4)
    quad = mf.micro_reference(at, bp, "quad", precision, reps=4)
    assert all(torch.equal(w, q) for w, q in zip(wide, quad))
    assert wide[1].shape == (256, 384) and wide[1].abs().max() > 0


def test_ctypes_signatures_match_the_c_entries():
    """Each C entry of micro_fine.cu takes as many arguments, pointers and
    ints in the same places, as the wrapper's ctypes table declares (a
    short table would be caught only by a launch on the card)."""
    import ctypes
    import os
    import re

    src = open(os.path.join(os.path.dirname(mf.__file__), "csrc", "micro_fine.cu")).read()
    entries = dict(re.findall(r"^int (hbsm_\w+)\(([^)]*)\)", src, re.M))
    assert set(entries) == set(mf.SIGNATURES)
    for name, params in entries.items():
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params.split(",")]
        assert kinds == mf.SIGNATURES[name], name


def test_time_micro_designs_needs_a_card(capsys):
    """The two-checkout timing script measures nothing off the card: it
    exits 2 and prints no turn."""
    from hierarchical_block_sparse_lib_tpu_torch.scripts import time_micro_designs as tmd

    assert tmd.main(tmd.THIS_ROOT) == 2
    assert "turn" not in capsys.readouterr().out


def test_time_micro_designs_takes_several_roots_and_needs_a_card(tmp_path, capsys):
    """With variant checkouts beside the parent the timer still measures
    nothing off the card, and runs no turn."""
    from hierarchical_block_sparse_lib_tpu_torch.scripts import time_micro_designs as tmd

    roots = [str(tmp_path / name) for name in ("parent", "variant")]
    assert tmd.main(*roots) == 2
    assert "turn" not in capsys.readouterr().out


def test_e12_records_bound_on_the_tiers_route():
    """micro_fine_kernel2's E12 records take the bound of the route each
    tier runs (3xTF32 at "highest", bf16 at "default"), on the script's
    flops and bytes."""
    from hierarchical_block_sparse_lib_tpu_torch.scripts import micro_fine_kernel2 as m2
    from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import bound

    recs = m2.main("cpu", m2.TINY)
    ra, nbrow = m2.TINY.RA, m2.TINY.NBROW
    flops = 2 * 32**3 * ra * nbrow
    nbytes = 4 * (ra * 32 * 32 + 8 * nbrow * 128 + ra * nbrow) + 4 * mf.ACC_ROWS * 128
    for prec, route in (("highest", "tf32x3"), ("default", "bf16")):
        for adds in (True, False):
            rec = recs[f"E12 {prec} adds={adds}"]
            assert (rec["bound_ms"], rec["bound_by"]) == bound(flops, nbytes, route)


def _e12_source():
    import os

    return open(os.path.join(os.path.dirname(mf.__file__), "csrc", "micro_fine.cu")).read()


def _e12_scan_shape():
    """(entries a chunk, warps, entries a lane takes a step, entries a
    step) as micro_fine.cu's e12_scan declares them."""
    import re

    src = _e12_source()
    chunk, warps = (int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))
                    for name in ("kE12Chunk", "kE12Warps"))
    per_lane = int(re.search(r"int first = base \+ kE12WarpSpan \* warp \+ (\d+) \* lane;",
                             src).group(1))
    step = int(re.search(r"kSteps = kE12WarpSpan / (\d+);", src).group(1))
    return chunk, warps, per_lane, step


def e12_slot_walk(slots, n_slots):
    """A numpy model of the order in which the `e12` kernel's block for
    each slot is written to run its entries (micro_fine.cu's e12_scan,
    whose chunk, warp count, lane width and step width it reads from the
    source): idx in chunks, warp w scanning the chunk's w-th share in
    steps, lane l taking entries per_lane * l + [0, per_lane) of a step.  A
    hit's place in the chunk's list is the hits of earlier warps (their
    totals), then of the warp's earlier steps, then of lower lanes in its
    step (ballots), then its own lower bits.  Slots out of [0, n_slots)
    belong to no block.  It models the design, not the CUDA code: chip_smoke
    holds the kernel itself against its plain version on the card."""
    chunk, warps, per_lane, step = _e12_scan_shape()
    assert step == 32 * per_lane  # a step is one load of every lane
    steps = chunk // warps // step
    walks = [[] for _ in range(n_slots)]
    for base in range(0, len(slots), chunk):
        part = np.asarray(slots[base:base + chunk])
        padded = np.full(chunk, -1, np.int64)
        padded[:part.size] = part
        grid = padded.reshape(warps, steps, 32, per_lane)
        local = np.arange(chunk).reshape(warps, steps, 32, per_lane)
        for p in np.unique(part[(part >= 0) & (part < n_slots)]):
            flags = grid == p
            lane_cnt = flags.sum(axis=3)
            step_cnt = lane_cnt.sum(axis=2)
            warp_cnt = step_cnt.sum(axis=1)
            pos = ((np.cumsum(warp_cnt) - warp_cnt)[:, None, None, None]
                   + (np.cumsum(step_cnt, axis=1) - step_cnt)[:, :, None, None]
                   + (np.cumsum(lane_cnt, axis=2) - lane_cnt)[:, :, :, None]
                   + np.cumsum(flags, axis=3) - 1)
            hits = np.empty(int(warp_cnt.sum()), np.int64)
            hits[pos[flags]] = local[flags]
            walks[p].extend(base + hits)
    return walks


def _e12_cases():
    rng = np.random.default_rng(12)
    nbrow = 26
    n_small, n_two = 5 * nbrow, 320 * nbrow  # within one chunk, and past it
    return {
        "random": rng.integers(-20, 530, n_small),
        "random, two chunks": rng.integers(-20, 530, n_two),
        "all in one slot": np.full(n_two, 7),
        "none in range": rng.choice([-3, 512, 900], n_two),
        "slot t (the order without adds)": np.arange(n_two) % nbrow,
    }


@pytest.mark.parametrize("case", list(_e12_cases()))
def test_e12_slot_walk_is_the_order_of_the_runs(case):
    """Per slot, the walk the kernel is designed to do (e12_slot_walk) is
    the slot's entries in ascending (e, t) order, the order `_runs` gives
    the plain version; out-of-range slots are dropped."""
    slots = _e12_cases()[case].astype(np.int32)
    walks = e12_slot_walk(slots, N_SLOTS)
    order, run_start = (t.numpy() for t in mf._runs(torch.from_numpy(slots), N_SLOTS))
    for p in range(N_SLOTS):
        np.testing.assert_array_equal(walks[p], order[run_start[p]:run_start[p + 1]],
                                      err_msg=f"slot {p}")
    in_range = int(((slots >= 0) & (slots < N_SLOTS)).sum())
    assert sum(len(w) for w in walks) == in_range
    if case.startswith("slot t"):
        # Without the adds the kernel scans nothing: slot t < nbrow walks
        # entries t, t + nbrow, ... (e ascending), the same order.
        nbrow = 26
        for p in range(N_SLOTS):
            want = np.arange(p, len(slots), nbrow) if p < nbrow else np.zeros(0, np.int64)
            np.testing.assert_array_equal(walks[p], want, err_msg=f"slot {p}")
