"""PyTorch port vs the JAX package: the norm kernel module
(kernels/pallas_norms.py `block_frob_squared`, `norms_and_keep`; the JAX
kernels in interpret mode) and the b % 128 == 0 dispatch of ops/norms.py
and ops/truncate.py onto it."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.kernels import pallas_norms as jax_norms
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms

from torch_port_helpers import assert_same_matrix, matrix_pair


def blocks(cap, b, seed):
    """N(0,1) blocks scaled apart (block k by 1 + k/10), two of them zero
    (padding-style)."""
    data = np.random.default_rng(seed).standard_normal((cap, b, b)).astype(np.float32)
    data *= (1 + 0.1 * np.arange(cap, dtype=np.float32))[:, None, None]
    data[1] = 0
    data[cap - 2] = 0
    return data


def tau_between(n2):
    """A threshold in the middle of the widest relative gap between
    neighbouring block norms; no norm lies within 1e-3 relative of it
    (asserted)."""
    norms = np.sort(np.sqrt(n2))
    m = int(np.argmax(norms[1:] / norms[:-1])) + 1
    tau = 0.5 * (norms[m - 1] + norms[m])
    assert np.min(np.abs(norms / tau - 1)) > 1e-3
    return float(tau)


@pytest.mark.parametrize("cap,b", [(13, 8), (37, 16), (5, 128)])
def test_norm_kernels_match_jax(cap, b):
    data = blocks(cap, b, cap)
    want = np.asarray(jax_norms.block_frob_squared(data, chunk=8))
    got = pallas_norms.block_frob_squared(torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1] == 0 and got[cap - 2] == 0
    tau = tau_between(want[want > 0])
    jn2, jkeep = jax_norms.norms_and_keep(data, np.float32(tau), chunk=8)
    n2, keep = pallas_norms.norms_and_keep(torch.from_numpy(data), tau)
    np.testing.assert_allclose(n2.numpy(), np.asarray(jn2), rtol=1e-6)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert keep.dtype == torch.bool and 0 < int(keep.sum()) < cap
    # A 0-dim tensor tau gives the same mask.
    np.testing.assert_array_equal(
        pallas_norms.norms_and_keep(torch.from_numpy(data), torch.tensor(tau))[1].numpy(),
        np.asarray(jkeep),
    )


def test_ops_dispatch_onto_the_norm_kernels(monkeypatch):
    """At b % 128 == 0 with f32/bf16 data the ops take the kernel module
    (its plain version here), as the reference does on its accelerator;
    other leaves keep the torch reduction."""
    calls = []
    real_bfs, real_nk = pallas_norms.block_frob_squared, pallas_norms.norms_and_keep
    monkeypatch.setattr(pallas_norms, "block_frob_squared",
                        lambda d: calls.append("bfs") or real_bfs(d))
    monkeypatch.setattr(pallas_norms, "norms_and_keep",
                        lambda d, t: calls.append("nk") or real_nk(d, t))
    jm, tm = matrix_pair(3, 3, 128, 0.7, 4, pad=1)
    np.testing.assert_allclose(
        tx.block_frob_squared(tm).numpy(), np.asarray(jx.block_frob_squared(jm)), rtol=1e-6
    )
    n2 = np.asarray(jx.block_frob_squared(jm))[: int(jm.nnz)]
    tau = tau_between(n2)
    assert_same_matrix(tx.truncate(tm, tau), jx.truncate(jm, tau), rtol=0, atol=0)
    assert calls == ["bfs", "nk"]
    calls.clear()
    tx.truncate(matrix_pair(3, 3, 16, 0.7, 4)[1], 1.0)  # b=16: no kernel
    tx.block_frob_squared(tm.with_data(tm.data.double()))  # f64: no kernel
    assert calls == []


def test_supported_gates():
    assert pallas_norms.supported(128, torch.float32)
    assert pallas_norms.supported(256, torch.bfloat16)
    assert not pallas_norms.supported(64, torch.float32)
    assert not pallas_norms.supported(128, torch.float64)
