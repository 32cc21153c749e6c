"""PyTorch port vs the JAX package: block-sparse x dense products
(ops/spmm.py), as in tests/test_misc.py::test_spmm_spmv.  The same
numpy-built inputs go through both packages on the CPU: results within
1e-5 of max|Y| at "highest" and 2e-3 at "default", and against the dense
product."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx

from torch_port_helpers import rel_to_max, to_port

TOL = {"highest": 1e-5, "default": 2e-3}


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_spmm_spmv_match_jax(precision):
    n, m, b = 144, 48, 16
    rng = np.random.default_rng(2)
    d = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.25)).astype(np.float32)
    ja = jx.from_dense(d, block_size=b)
    ta = to_port(ja)
    x = rng.standard_normal((n, m)).astype(np.float32)
    got = tx.spmm(ta, torch.from_numpy(x), alpha=0.5, precision=precision).numpy()
    want = np.asarray(jx.spmm(ja, jnp.asarray(x), alpha=0.5, precision=precision))
    assert got.shape == want.shape == (n, m)
    assert rel_to_max(got, want) <= TOL[precision]
    np.testing.assert_allclose(got, 0.5 * d @ x, rtol=2e-5, atol=2e-5)
    v = rng.standard_normal(n).astype(np.float32)
    got = tx.spmv(ta, torch.from_numpy(v), precision=precision).numpy()
    want = np.asarray(jx.spmv(ja, jnp.asarray(v), precision=precision))
    assert got.shape == want.shape == (n,)
    assert rel_to_max(got, want) <= TOL[precision]
    np.testing.assert_allclose(got, d @ v, rtol=2e-5, atol=2e-5)


def test_spmm_ragged_and_checks():
    """Row and column counts that are not block multiples (X's rows pad
    the last block column), a 0-dim alpha, and the shape check."""
    n, m, b = 144, 5, 16
    rng = np.random.default_rng(3)
    d = (rng.standard_normal((n, n - 8)) * (rng.random((n, n - 8)) < 0.3)).astype(np.float32)
    ja = jx.from_dense(d, block_size=b)
    ta = to_port(ja)
    x = rng.standard_normal((n - 8, m)).astype(np.float32)
    got = tx.spmm(ta, torch.from_numpy(x), alpha=torch.tensor(-2.0)).numpy()
    want = np.asarray(jx.spmm(ja, jnp.asarray(x), alpha=-2.0))
    assert rel_to_max(got, want) <= TOL["highest"]
    np.testing.assert_allclose(got, -2.0 * d @ x, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="shape mismatch"):
        tx.spmm(ta, torch.zeros((n, m)))
