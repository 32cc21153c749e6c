"""The port's micro-benchmark kernels `e3` and `e12` (kernels/micro_fine.py;
on the CPU, their plain versions) against the JAX kernels of
scripts/micro_fine_kernel2.py in interpret mode, on the same numpy-built
inputs; the whole accumulator against oracles; and the port's
scripts/micro_fine_kernel2.py at a small size.

R3 and RA are globals of the JAX script, read when `e3` and `e12` trace,
so they are set once here before the first call.
"""

import numpy as np
import pytest
import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf
from hierarchical_block_sparse_lib_tpu_torch.scripts import micro_fine_kernel2 as port_script

from torch_port_helpers import bf16_rounded, import_jax_script, interpret_zero, rel_to_max

jax_micro2 = import_jax_script("micro_fine_kernel2")
R3, RA, NBROW = 64, 4, jax_micro2.NBROW
jax_micro2.R3 = R3
jax_micro2.RA = RA

# As for `micro` (test_torch_micro_fine.py): f32 sums in another order at
# "highest"; at "default" JAX is handed the bf16-rounded operands.
TOL = {"highest": 1e-5, "default": 2e-3}


def e3_inputs(seed, n_slots=6):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_slots, R3).astype(np.int32)
    idx[[0, 5, 17, 40]] = 0  # slot 0 is the [8, 128] output
    v = rng.standard_normal((8, 128)).astype(np.float32)
    return idx, v


def e3_oracle(idx, v):
    """The serial loop, in f32, as the TPU kernel runs it."""
    acc = np.zeros((mf.ACC_ROWS, 128), np.float32)
    for p in idx:
        if 0 <= p < mf.ACC_ROWS // 8:
            acc[8 * p:8 * p + 8] += v
    return acc


def e12_inputs(seed=0):
    rng = np.random.default_rng(seed)
    a_wide = (rng.standard_normal((RA, 32, 128)) * 0.1).astype(np.float32)
    panel = (rng.standard_normal((8 * NBROW, 128)) * 0.1).astype(np.float32)
    idx = rng.integers(0, 500, RA * NBROW).astype(np.int32)
    idx[[3, 30, 77]] = 0  # three products into the output slot
    return a_wide, panel, idx


def e12_oracle(a_wide, panel, idx, do_adds):
    """Every leaf product X_t L_e in float64, summed into its slot."""
    acc = np.zeros((mf.ACC_ROWS // 8, 32, 32))
    x = panel.astype(np.float64).reshape(NBROW, 32, 32)
    for e in range(RA):
        lg = a_wide[e, :, 0:32].astype(np.float64)
        for t in range(NBROW):
            acc[idx[e * NBROW + t] if do_adds else t] += x[t] @ lg
    return acc.reshape(mf.ACC_ROWS, 128)


@pytest.mark.parametrize("seed", [0, 1])
def test_e3_matches_jax_exactly(seed):
    idx, v = e3_inputs(seed)
    with interpret_zero():
        want = np.asarray(jax_micro2.e3(idx, v))
    out, acc = mf.e3(torch.from_numpy(idx), torch.from_numpy(v))
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(acc.numpy(), e3_oracle(idx, v))


def test_e3_drops_slots_out_of_range():
    idx, v = e3_inputs(2)
    idx[[1, 2, 3]] = [512, 600, -1]
    _, acc = mf.e3(torch.from_numpy(idx), torch.from_numpy(v))
    np.testing.assert_array_equal(acc.numpy(), e3_oracle(idx, v))


@pytest.mark.parametrize("do_adds", [True, False])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_e12_matches_jax(precision, do_adds):
    a_wide, panel, idx = e12_inputs()
    ja, jp = (bf16_rounded(a_wide), bf16_rounded(panel)) if precision == "default" else (
        a_wide, panel)
    with interpret_zero():
        want = np.asarray(jax_micro2.e12(ja, jp, idx, precision, do_adds))
    out, acc = mf.e12(torch.from_numpy(a_wide), torch.from_numpy(panel), torch.from_numpy(idx),
                      precision, do_adds)
    assert out.shape == want.shape == (8, 128) and acc.shape == (mf.ACC_ROWS, 128)
    assert np.abs(want).max() > 0
    assert rel_to_max(out.numpy(), want) <= TOL[precision]


@pytest.mark.parametrize("do_adds", [True, False])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_e12_accumulator_matches_f64_leaf_products(precision, do_adds):
    """The whole accumulator against the float64 leaf products (of the
    bf16-rounded operands at "default")."""
    a_wide, panel, idx = e12_inputs(1)
    _, acc = mf.e12(torch.from_numpy(a_wide), torch.from_numpy(panel), torch.from_numpy(idx),
                    precision, do_adds)
    if precision == "default":
        a_wide, panel = bf16_rounded(a_wide), bf16_rounded(panel)
    want = e12_oracle(a_wide, panel, idx, do_adds)
    assert rel_to_max(acc.numpy(), want) <= 1e-6
    touched = np.unique(idx) if do_adds else np.arange(NBROW)
    assert np.all(np.abs(want.reshape(-1, 1024)[touched]).max(axis=1) > 0)


def test_micro2_script_runs_on_the_cpu():
    recs = port_script.main("cpu", port_script.TINY)
    assert {"E2x reshape", "E2x stack", "E2x concat", "E3", "E12 highest adds=True",
            "E12 default adds=False", "E11 payloadT+flat", "E11 flat"} <= set(recs)
    assert all(rec["ms"] is None for rec in recs.values())
    assert recs["E3"]["bitwise"] and recs["E2x stack"]["bitwise"]
