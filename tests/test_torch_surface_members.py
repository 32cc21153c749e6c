"""The BlockMatrix id helpers (`block_rows`, `block_cols`, `make_id`),
`BlockMatrix.density` and `FineFlat.fr` in both packages, on the same
numpy-built inputs.

Matrices: a square random one with padding slots, the ragged rectangular
72x104 at leaf 8 of `tests/test_stress.py`, and an empty one with spare
capacity, each in f32, bf16 and f64 (x64 on, as `tests/test_x64.py` has
it).  Ids and their helpers must be exactly equal, padding included;
`density` bitwise.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx

from torch_port_helpers import matrix_pair

DTYPES = {
    "f32": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "f64": (jnp.float64, torch.float64),
}


def _ragged_dense():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((72, 104)) * (rng.random((72, 104)) < 0.4)).astype(
        np.float32
    )


def _pair(case):
    """(JAX, port) f32 matrices of one input."""
    if case == "square":
        return matrix_pair(12, 12, 8, 0.3, seed=3, pad=5)
    if case == "ragged":
        d = _ragged_dense()
        return jx.from_dense(d, block_size=8), tx.from_dense(torch.from_numpy(d), block_size=8)
    return jx.empty(64, 64, 8, cap=3), tx.empty(64, 64, 8, cap=3, device="cpu")


@pytest.fixture(params=sorted(DTYPES))
def dtype_name(request):
    """The dtype's name, with x64 on for f64 (as `tests/test_x64.py`)."""
    ctx = jax.enable_x64(True) if request.param == "f64" else contextlib.nullcontext()
    with ctx:
        yield request.param


@pytest.mark.parametrize("case", ["square", "ragged", "empty"])
def test_id_helpers_and_density_match_jax(case, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    jm, tm = _pair(case)
    jm, tm = jm.with_data(jm.data.astype(jdt)), tm.with_data(tm.data.to(tdt))
    assert tm.dtype == tdt and jm.dtype == jdt
    assert tm.cap > int(tm.nnz) or case == "ragged"  # padding slots are compared

    for name in ("block_rows", "block_cols"):
        got, want = getattr(tm, name)(), np.asarray(getattr(jm, name)())
        assert got.dtype == torch.int32 and want.dtype == np.int32, name
        assert got.device == tm.device
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)

    # make_id on tensors/arrays (padding wraps in int32 on both sides), on
    # numpy arrays, and on Python ints.
    got = tm.make_id(tm.block_rows(), tm.block_cols())
    want = np.asarray(jm.make_id(jm.block_rows(), jm.block_cols()))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    valid = tm.valid_mask()
    assert torch.equal(got[valid], tm.ids[valid])
    r, c = np.arange(tm.nb_rows), np.arange(tm.nb_rows) % tm.nb_cols
    got_np, want_np = tm.make_id(r, c), jm.make_id(r, c)
    assert got_np.dtype == want_np.dtype
    np.testing.assert_array_equal(got_np, want_np)
    for brow, bcol in ((0, 0), (tm.nb_rows - 1, tm.nb_cols - 1), (3, 2)):
        got_i, want_i = tm.make_id(brow, bcol), jm.make_id(brow, bcol)
        assert type(got_i) is type(want_i) is int and got_i == want_i

    got, want = tm.density(), np.asarray(jm.density())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == () == want.shape and got.device == tm.device
    assert got.numpy().tobytes() == want.tobytes()  # bitwise
    assert float(got) == np.float32(int(tm.nnz)) / np.float32(tm.nb_rows * tm.nb_cols)


@pytest.mark.parametrize("b", [16, 32, 64])
def test_fine_flat_fr_matches_jax(b):
    jm, tm = matrix_pair(4, 4, b, 0.5, seed=b)
    jf, tf = jx.fine_pack(jm), tx.fine_pack(tm)
    assert tf.fr == jf.fr == b * b // 128 == tf.data.shape[1]
    assert isinstance(tf.fr, int)
