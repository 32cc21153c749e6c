"""PyTorch port vs the JAX package: the norm kernel module
(kernels/pallas_norms.py `block_frob_squared`, `norms_and_keep`; the JAX
kernels in interpret mode) and the b % 128 == 0 dispatch of ops/norms.py
and ops/truncate.py onto it; the plain truncation against the body it had
before the truncate kernels (tests/former_truncate.py), and the rules of
kernels/truncate.py that the CPU can reach."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.kernels import pallas_norms as jax_norms
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_norms
from hierarchical_block_sparse_lib_tpu_torch.kernels import truncate as truncate_kernels
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate_reference

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


F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64
# name: (block rows and columns, b, dtype, density, pad, tau kind, cap,
# subtree level); the tau kinds: "number", "tensor" (0-dim), "zero" (every
# nonzero block kept) and "huge" (none kept); cap None keeps the input's
# capacity, "over" is smaller than the survivors.
TRUNCATIONS = {
    "b16_f32": (6, 6, 16, F32, 0.6, 3, "number", None, None),
    "b32_f32_cap_over": (6, 5, 32, F32, 0.7, 2, "number", "over", None),
    "b32_f32_cap_wider": (5, 5, 32, F32, 0.5, 1, "number", 40, None),
    "b32_bf16": (5, 6, 32, BF16, 0.6, 2, "number", None, None),
    "b32_f64_tensor": (5, 5, 32, F64, 0.6, 2, "tensor", 10, None),
    "b64_f32_tensor": (4, 4, 64, F32, 0.6, 1, "tensor", None, None),
    "b64_f64_cap_over": (4, 4, 64, F64, 0.7, 1, "number", "over", None),
    "b128_f32": (3, 3, 128, F32, 0.7, 1, "number", None, None),
    "b128_bf16_cap_over": (3, 3, 128, BF16, 0.8, 1, "tensor", "over", None),
    "b16_zero": (5, 5, 16, F32, 0.5, 2, "zero", None, None),
    "b16_huge": (5, 5, 16, F32, 0.5, 2, "huge", 8, None),
    "b16_subtree": (8, 8, 16, F32, 0.4, 2, "number", None, 2),
    "b32_subtree_cap_over": (8, 8, 32, F32, 0.4, 1, "tensor", "over", 1),
}


@pytest.mark.parametrize("name", list(TRUNCATIONS))
def test_plain_truncation_equals_the_former_body_bitwise(name):
    """On the CPU `truncate` is its plain version (`truncate_reference`:
    `keep_reference`, then `compact_reference`), bit for bit the body it
    had before the truncate kernels, with `cap` below and above the
    survivors, bf16, f64, a tensor tau and subtree mode."""
    from former_truncate import assert_same_truncation, former_truncate

    nbr, nbc, b, dtype, density, pad, tau_kind, cap, level = TRUNCATIONS[name]
    tm = matrix_pair(nbr, nbc, b, density, len(name), pad=pad)[1]
    tm = tm.with_data(tm.data.to(dtype))
    n2 = tm.data.double().square().sum(dim=(1, 2))[: int(tm.nnz)].numpy()
    tau = {"zero": 0.0, "huge": 1e9}[tau_kind] if tau_kind in ("zero", "huge") else \
        tau_between(n2)
    if tau_kind == "tensor":
        tau = torch.tensor(tau)
    kept = int((np.sqrt(n2) > float(tau)).sum()) if level is None else None
    if cap == "over":
        cap = int(tm.nnz) // 2 if level is not None else kept - 2
    launches = truncate_kernels.truncate_kernel.launches
    got = tx.truncate(tm, tau, subtree_level=level, cap=cap)
    want = former_truncate(tm, tau, subtree_level=level, cap=cap)
    assert_same_truncation(got, want)
    assert_same_truncation(truncate_reference(tm, tau, level, cap), want)
    assert truncate_kernels.truncate_kernel.launches == launches
    m = got[0] if cap is not None else got
    if kept is not None:
        assert int(m.nnz) == min(kept, m.cap)
    if "over" in name:
        assert int(got[1]) > cap == int(m.nnz)


@pytest.mark.parametrize("b, dtype, want", [
    (16, torch.float32, "truncate"), (32, torch.float32, "truncate"),
    (32, torch.bfloat16, "truncate"), (64, torch.float64, "truncate"),
    (128, torch.float32, "norms_and_keep"), (128, torch.bfloat16, "norms_and_keep"),
    (256, torch.float32, "norms_and_keep"), (128, torch.float64, "truncate"),
    (384, torch.bfloat16, "norms_and_keep"), (256, torch.float64, "truncate"),
])
def test_norm_pass_by_leaf_and_type(b, dtype, want):
    """The card's keep comes from the norms kernel where it did before (its
    keep unchanged to the bit), from the truncate norm pass elsewhere:
    `truncate` asks `pallas_norms.supported`."""
    assert pallas_norms.supported(b, dtype) == (want == "norms_and_keep")


def test_tiles_and_refusals():
    """A tile is 256 slots up to 262 144 slots (1 024 tiles at the SP2
    step), then grows by 256 so the tiles stay at most 1 024; the kernels
    take CUDA tensors only."""
    assert [truncate_kernels.tile_slots(c) for c in (0, 1, 644, 262_144, 262_145, 10**6)] == [
        256, 256, 256, 256, 512, 1024]
    assert all(-(-c // truncate_kernels.tile_slots(c)) <= truncate_kernels.MAX_TILES
               for c in (1, 262_145, 10**6, 2**27))
    ids = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        truncate_kernels.truncate_kernel(ids, torch.zeros((4, 32, 32)), 4, tau2=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        truncate_kernels.block_norms_keep(ids, torch.zeros((4, 32, 32)), 1.0)
