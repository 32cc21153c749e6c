"""Morton codes (core/morton.py), the remaining norms (`frob_norm`,
`nnz_blocks`, `gershgorin_bound`, `subtree_frob_squared`) and subtree
truncation in the port against the JAX package, after
tests/test_basic_ops.py's subtree-norm, subtree-truncation and Gershgorin
tests.  The JAX package has no test of its own for `frob_norm` and
`nnz_blocks`; they are held against its functions directly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.core import morton as jmorton
from hierarchical_block_sparse_lib_tpu_torch.core import morton as tmorton

from torch_port_helpers import assert_same_matrix, matrix_pair, np_, random_blocks, to_port


def _codes():
    """Random 16-bit coordinates and the edges: 0, 1, 2^15 - 1, 2^15 and
    2^16 - 1 (whose codes set bit 31), and values past 16 bits."""
    rng = np.random.default_rng(3)
    edges = np.array([0, 1, 2**15 - 1, 2**15, 2**16 - 1, 2**16, 2**20 + 5], np.int32)
    r = np.concatenate([rng.integers(0, 2**16, 200), edges, edges[::-1]]).astype(np.int32)
    c = np.concatenate([rng.integers(0, 2**16, 200), edges, edges]).astype(np.int32)
    return r, c


def test_morton_matches_jax():
    r, c = _codes()
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    for got, want in (
        (tmorton.interleave_bits(tr), jmorton.interleave_bits(jnp.asarray(r))),
        (tmorton.deinterleave_bits(tr), jmorton.deinterleave_bits(jnp.asarray(r))),
    ):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    code = tmorton.encode(tr, tc)
    jcode = jmorton.encode(jnp.asarray(r), jnp.asarray(c))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    assert code.dtype == torch.int32 and int(code.min()) < 0  # bit 31 set at 2^15
    for got, want in zip(tmorton.decode(code), jmorton.decode(jcode)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    low = (r < 2**16) & (c < 2**16)
    np.testing.assert_array_equal(tmorton.decode(code)[0].numpy()[low], r[low])
    for depth, level in ((16, 0), (16, 3), (16, 16), (5, 2)):
        np.testing.assert_array_equal(
            tmorton.subtree_key(code, depth, level).numpy(),
            np.asarray(jmorton.subtree_key(jcode, depth, level)),
        )


@pytest.mark.parametrize("shape", [(6, 6), (5, 9)])
def test_norms_match_jax(shape):
    jm, tm = matrix_pair(*shape, 16, 0.5, 12, pad=3)
    np.testing.assert_allclose(float(tx.frob_norm(tm)), float(jx.frob_norm(jm)), rtol=1e-6)
    assert int(tx.nnz_blocks(tm)) == int(jx.nnz_blocks(jm))
    np.testing.assert_allclose(float(tx.gershgorin_bound(tm)), float(jx.gershgorin_bound(jm)),
                               rtol=1e-6)
    for level in (0, 1, 2, 3):
        tk, tn = tx.subtree_frob_squared(tm, level)
        jk, jn = jx.subtree_frob_squared(jm, level)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert tn.shape == (4**level,)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=0)


def _pair(n=96, b=16, seed=0):
    """tests/test_basic_ops.py's banded input, in both packages."""
    from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen

    r1, c1, v1 = gen.banded_coo(n, 4, seed=seed)
    A = tx.from_coo(r1, c1, v1, n, block_size=b, device="cpu")
    return jx.from_coo(r1, c1, v1, n, block_size=b), A, gen.dense_oracle(r1, c1, v1, n)


def test_subtree_norms_sum_to_total():
    _, A, dA = _pair()
    for level in (0, 1, 2):
        _, norms2 = tx.subtree_frob_squared(A, level)
        np.testing.assert_allclose(float(norms2.sum()), float((dA**2).sum()), rtol=1e-5)


def test_truncate_subtree():
    n, b = 64, 8
    rng = np.random.default_rng(8)
    x = rng.standard_normal((n, n)).astype(np.float32)
    x[:32, :32] *= 1e-8  # a whole level-1 quadrant tiny
    A = tx.from_dense(torch.from_numpy(x), block_size=b)
    T = tx.truncate(A, 1e-3, subtree_level=1)
    d = tx.to_dense(T).numpy()
    assert np.all(d[:32, :32] == 0)
    np.testing.assert_allclose(d[32:, :], x[32:, :], rtol=1e-6)
    assert_same_matrix(T, jx.truncate(jx.from_dense(x, block_size=b), 1e-3, subtree_level=1),
                       rtol=0, atol=0)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_truncate_subtree_matches_jax(level):
    """tau halfway between two neighbouring node norms (no node near it),
    with and without `cap`."""
    ids, data, nnz = random_blocks(8, 8, 16, 0.6, 40 + level, pad=2)
    rng = np.random.default_rng(level)
    data = (data * 10.0 ** rng.uniform(-6, 0, (len(ids), 1, 1))).astype(np.float32)
    jm = jx.BlockMatrix(ids=jnp.asarray(ids), data=jnp.asarray(data), nnz=jnp.asarray(nnz),
                        n_rows=128, n_cols=128, block_size=16)
    tm = to_port(jm)
    _, node2 = tx.subtree_frob_squared(tm, level)
    norms = np.sort(np.sqrt(node2.numpy()[node2.numpy() > 0]))
    k = len(norms) // 2
    assert norms[k] > norms[k - 1] * (1 + 1e-3)
    tau = float(0.5 * (norms[k] + norms[k - 1]))
    got = tx.truncate(tm, tau, subtree_level=level)
    assert 0 < int(got.nnz) < int(tm.nnz)
    assert_same_matrix(got, jx.truncate(jm, tau, subtree_level=level), rtol=0, atol=0)
    got_c, kept = tx.truncate(tm, tau, subtree_level=level, cap=3)
    want_c, want_kept = jx.truncate(jm, tau, subtree_level=level, cap=3)
    assert_same_matrix(got_c, want_c, rtol=0, atol=0)
    assert int(kept) == int(want_kept)


def test_gershgorin_bound():
    rng = np.random.default_rng(17)
    d = (rng.standard_normal((96, 96)) * (rng.random((96, 96)) < 0.3)).astype(np.float32)
    d = (d + d.T) / 2
    A = tx.from_dense(torch.from_numpy(d), block_size=16)
    g = float(tx.gershgorin_bound(A))
    np.testing.assert_allclose(g, np.abs(d).sum(axis=1).max(), rtol=1e-5)
    assert g >= np.abs(np.linalg.eigvalsh(d)).max() - 1e-4
    np.testing.assert_allclose(g, float(jx.gershgorin_bound(jx.from_dense(d, block_size=16))),
                               rtol=1e-6)
    assert np_(tx.gershgorin_bound(A.with_data(A.data.double()))).dtype == np.float64
