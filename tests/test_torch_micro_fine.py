"""The port's micro-benchmark kernels `micro` and `e2`
(kernels/micro_fine.py; on the CPU, their plain versions) against the JAX
kernels of scripts/micro_fine_kernel.py::micro and
scripts/micro_fine_kernel2.py::e2 in interpret mode, on the same
numpy-built inputs, and the port's scripts/micro_fine_kernel.py at a
small size.

`micro` runs R reps in the kernel; R is a global of the JAX script, read
when `micro` traces, so it is set once here before the first call.  With
scratch zeroed, the JAX kernel's accumulator starts at zero as the port's
does.
"""

import jax
import numpy as np
import pytest
import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf
from hierarchical_block_sparse_lib_tpu_torch.scripts import micro_fine_kernel as port_script

from torch_port_helpers import (
    JAX_CACHE_SETTINGS,
    bf16_rounded,
    import_jax_script,
    interpret_zero,
    rel_to_max,
)

jax_micro = import_jax_script("micro_fine_kernel")
jax_micro2 = import_jax_script("micro_fine_kernel2")
R = 3
jax_micro.R = R

# Port vs JAX, relative to max|JAX|.  "highest": f32 sums in another
# order.  "default": the port rounds at*s_i to bf16 and JAX is handed
# bf16(at), then scales it by s_i in f32: the two differ where at*s_i
# rounds across a bf16 boundary.
TOL = {"highest": 1e-5, "default": 2e-3}
SHAPES = {"wide": (256, 128), "quad": (256, 384), "flatten": (128, 128)}


def operands(mode, seed=0):
    rng = np.random.default_rng(seed)
    la, lb = SHAPES[mode]
    at = (rng.standard_normal((32, la)) * 0.1).astype(np.float32)
    bp = (rng.standard_normal((32, lb)) * 0.1).astype(np.float32)
    return at, bp


def oracle(at, bp, mode, reps=R):
    """The whole accumulator in float64: s_i and at*s_i rounded in f32 as
    the kernels round them, every sum exact."""
    la, lb = at.shape[1], bp.shape[1]
    acc = np.zeros((max(la, 256), max(lb, 128)))
    scales = mf.rep_scales(reps)
    if mode == "flatten":
        acc[128:256, 0:128] = scales.astype(np.float64).sum()
    else:
        for s in scales:
            acc[:la, :lb] += (at * s).astype(np.float64).T @ bp.astype(np.float64)
    return acc


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("mode", ["wide", "quad", "flatten"])
def test_micro_matches_jax(mode, precision):
    at, bp = operands(mode)
    jat, jbp = (bf16_rounded(at), bf16_rounded(bp)) if precision == "default" else (at, bp)
    with interpret_zero():
        want = np.asarray(jax_micro.micro(jat, jbp, mode, precision))
    out, acc = mf.micro(torch.from_numpy(at), torch.from_numpy(bp), mode, precision, reps=R)
    assert out.shape == want.shape == (8, 128)
    assert acc.shape == (max(at.shape[1], 256), max(bp.shape[1], 128))
    assert rel_to_max(out.numpy(), want) <= TOL[precision]
    np.testing.assert_array_equal(out.numpy(), acc[0:8, 0:128].numpy())


@pytest.mark.parametrize("mode", ["wide", "quad", "flatten"])
def test_micro_accumulator_matches_f64_oracle(mode):
    """The whole accumulator, which the [8, 128] output hides: "flatten"
    leaves rows 0..127 at zero and fills rows 128..255."""
    at, bp = operands(mode, seed=1)
    _, acc = mf.micro(torch.from_numpy(at), torch.from_numpy(bp), mode, "highest", reps=R)
    want = oracle(at, bp, mode)
    assert rel_to_max(acc.numpy(), want) <= 1e-6
    assert np.count_nonzero(want[128:256]) > 0


def test_micro_default_rounds_to_bf16():
    at, bp = operands("wide", seed=2)
    _, acc = mf.micro(torch.from_numpy(at), torch.from_numpy(bp), "wide", "default", reps=R)
    _, full = mf.micro(torch.from_numpy(at), torch.from_numpy(bp), "wide", "highest", reps=R)
    rounded = oracle(bf16_rounded(at), bf16_rounded(bp), "wide")
    assert rel_to_max(acc.numpy(), rounded) <= 1e-5
    assert rel_to_max(acc.numpy(), full.numpy()) > 1e-4  # one bf16 pass, not f32


@pytest.mark.parametrize("variant", ["reshape", "stack", "concat"])
def test_e2_equals_reshape_bitwise(variant):
    x = np.random.default_rng(3).standard_normal((32, 32)).astype(np.float32)
    with interpret_zero():
        want = np.asarray(jax_micro2.e2(x, variant))
    got = mf.e2(torch.from_numpy(x), variant).numpy()
    np.testing.assert_array_equal(got, x.reshape(8, 128))
    np.testing.assert_array_equal(got, want)


def test_micro_and_e2_reject_bad_input():
    at, bp = (torch.from_numpy(a) for a in operands("wide"))
    with pytest.raises(ValueError, match="quad"):
        mf.micro(at[:, :200], bp, "quad")
    with pytest.raises(ValueError, match="mode"):
        mf.micro(at, bp, "tall")
    with pytest.raises(ValueError, match="precision"):
        mf.micro(at, bp, "wide", "high")
    with pytest.raises(ValueError, match="variant"):
        mf.e2(torch.zeros(32, 32), "transpose")


def test_wrappers_take_no_plain_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel, which raises for a device that is not CUDA."""
    at, bp = (torch.from_numpy(a).to("meta") for a in operands("wide"))
    for call in (lambda: mf.micro(at, bp, "wide"), lambda: mf.e2(at[:, :32].contiguous(), "reshape")):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_micro_script_runs_on_the_cpu():
    recs = port_script.main("cpu", port_script.TINY)
    assert {"E1a wide highest", "E1b quad default", "E2 flatten", "E5", "E8 packT",
            "E9"} <= set(recs)
    for name, rec in recs.items():
        assert rec["ms"] is None, name  # no device time off the card
    assert recs["E1a wide highest"]["max_abs_err"] == 0.0
    assert recs["E1a wide highest"]["bound_by"] == "operations"


def test_jax_script_import_keeps_cache_settings():
    before = {k: getattr(jax.config, k) for k in JAX_CACHE_SETTINGS}
    import_jax_script("micro_fine_kernel")
    assert {k: getattr(jax.config, k) for k in JAX_CACHE_SETTINGS} == before
