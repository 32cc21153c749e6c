"""The redesigned micro kernels' contracts on the CPU: `e3` depends only on
how many entries each slot has (the property its one-launch kernel rests
on), `e3` with every entry in one slot against the JAX kernel of
scripts/micro_fine_kernel2.py in interpret mode, "quad" as the same
function as "wide", and the ctypes table against the C entries.

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
