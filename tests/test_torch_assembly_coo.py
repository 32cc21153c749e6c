"""COO export, element reads, the host loader's add/COO counts and npz
files (core/assembly.py, runtime/native.py, utils/serialization.py) in
both packages: the same numpy-built inputs through the JAX functions and
the port's, elements and ids held exactly equal (the export moves values,
it computes none).  Mirrors tests/test_assembly.py, tests/test_native.py
and tests/test_x64.py::test_assembly_round_trip_f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.runtime import native as jnative
from hierarchical_block_sparse_lib_tpu.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.runtime import native as tnative

from torch_port_helpers import SENTINEL, matrix_pair, np_, to_port


def coo_pair(n, b, density, seed):
    rows, cols, vals = gen.random_block_sparse_coo(n, b, density, seed=seed)
    jm = jx.from_coo(rows, cols, vals, n, block_size=b)
    return jm, tx.from_coo(rows, cols, vals, n, block_size=b, device="cpu"), (rows, cols, vals)


def test_to_coo_matches_jax():
    """to_coo: every element of every slot (padding and out-of-bounds
    elements masked) in the JAX package's order, bitwise; a capacity
    above nnz and a logical edge (n = 100 at b = 8) included."""
    jm, _, (rows, cols, vals) = coo_pair(100, 8, 0.3, 3)
    jm = jx.repack(jm, jm.cap + 3)
    tm = to_port(jm)
    got, want = tx.to_coo(tm), jx.to_coo(jm)
    for g, w in zip(got, want):
        assert np_(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np_(g), np.asarray(w))
    r, c, v, m = (np_(x) for x in got)
    back = gen.dense_oracle(r[m], c[m], v[m], 100)
    np.testing.assert_array_equal(back, gen.dense_oracle(rows, cols, vals, 100))


@pytest.mark.parametrize("chunk", [1, 3, 2048])
def test_to_coo_chunks_matches_jax(chunk):
    """Streamed export: the same chunks as the JAX package's for any chunk
    size, and no element emitted twice."""
    jm, tm, _ = coo_pair(100, 8, 0.3, 4)
    got = list(tx.to_coo_chunks(tm, chunk_blocks=chunk))
    want = list(jx.to_coo_chunks(jm, chunk_blocks=chunk))
    assert len(got) == len(want) == -(-int(jm.nnz) // min(chunk, jm.cap))
    for gc, wc in zip(got, want):
        for g, w in zip(gc, wc):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    r = np.concatenate([p[0] for p in got])
    c = np.concatenate([p[1] for p in got])
    assert len(np.unique(r.astype(np.int64) * 128 + c)) == len(r)


def test_to_coo_chunks_drop_zeros():
    x = np.zeros((16, 16), np.float32)
    x[0, 0] = 2.0  # block (0,0) stored, 63 explicit zeros inside it
    parts = list(tx.to_coo_chunks(tx.from_dense(torch.from_numpy(x), block_size=8),
                                  drop_zeros=True))
    want = list(jx.to_coo_chunks(jx.from_dense(x, block_size=8), drop_zeros=True))
    assert len(parts) == len(want) == 1
    for g, w in zip(parts[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert parts[0][2].tolist() == [2.0]


def test_get_values_matches_jax():
    """Reads from stored and absent blocks (absent read 0), as the JAX
    package's."""
    rows, cols, vals = gen.banded_coo(64, 3, seed=2)
    jm = jx.from_coo(rows, cols, vals, 64, block_size=8)
    tm = tx.from_coo(rows, cols, vals, 64, block_size=8, device="cpu")
    qr = np.array([0, 5, 63, 10, 0, 63], np.int32)
    qc = np.array([0, 5, 63, 60, 63, 0], np.int32)
    got = tx.get_values(tm, qr, qc)
    assert isinstance(got, torch.Tensor) and got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx.get_values(jm, qr, qc)))
    assert got[3] == got[4] == got[5] == 0


def random_ids(nb_rows, nb_cols, n, cap, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(nb_rows * nb_cols, size=n, replace=False)).astype(np.int32)
    return np.concatenate([ids, np.full(cap - n, SENTINEL, np.int32)])


@pytest.mark.parametrize("seed", [5, 6])
def test_plan_add_native_and_numpy(seed):
    """plan_add: C++ against the numpy fallback and the JAX loader."""
    a_ids = random_ids(16, 16, 30, 40, seed)
    b_ids = random_ids(16, 16, 50, 64, seed + 10)
    assert tnative.have_native()
    got = tnative.plan_add(a_ids, b_ids)
    assert got == tnative.plan_add_numpy(a_ids, b_ids) == jnative.plan_add(a_ids, b_ids)
    a, b = a_ids[a_ids != SENTINEL], b_ids[b_ids != SENTINEL]
    assert got == np.union1d(a, b).size
    empty = np.full(4, SENTINEL, np.int32)
    assert tnative.plan_add(empty, empty) == tnative.plan_add_numpy(empty, empty) == 0


def test_count_coo_blocks_native_and_numpy():
    """count_coo_blocks: C++ against the numpy fallback and the JAX loader,
    and the count the port's from_coo stores."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, 500).astype(np.int32)
    cols = rng.integers(0, 256, 500).astype(np.int32)
    got = tnative.count_coo_blocks(rows, cols, 16, 16)
    assert got == tnative.count_coo_blocks_numpy(rows, cols, 16, 16)
    assert got == jnative.count_coo_blocks(rows, cols, 16, 16)
    m = tx.from_coo(rows, cols, np.ones(500, np.float32), 256, block_size=16, device="cpu")
    assert int(m.nnz) == m.cap == got


def test_assembly_round_trip_f64():
    """test_x64.py::test_assembly_round_trip_f64 in both packages: float64
    to_coo equal to the JAX package's under x64, and back through from_coo
    bitwise."""
    rng = np.random.default_rng(0)
    d = (rng.standard_normal((192, 192)) * (rng.random((192, 192)) < 0.4)).astype(np.float64)
    tm = tx.from_dense(torch.from_numpy(d), block_size=16)
    assert tm.dtype == torch.float64
    np.testing.assert_array_equal(tx.to_dense(tm).numpy(), d)
    with jax.enable_x64(True):
        jm = jx.from_dense(d, block_size=16)
        want = [np.asarray(x) for x in jx.to_coo(jm)]
    got = [np_(x) for x in tx.to_coo(tm)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    r, c, v, m = got
    assert v.dtype == np.float64
    back = tx.from_coo(r[m], c[m], v[m], 192, block_size=16, device="cpu")
    np.testing.assert_array_equal(tx.to_dense(back).numpy(), d)


def same_file_arrays(p1, p2):
    with np.load(p1) as z1, np.load(p2) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        for k in z1.files:
            assert z1[k].dtype == z2[k].dtype, k
            assert z1[k].tobytes() == z2[k].tobytes(), k


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_npz_crosses_packages(tmp_path, dtype):
    """A file written by either package loads in the other, bitwise, and
    both write the same arrays."""
    jm, tm = matrix_pair(6, 5, 16, 0.4, 21, pad=3)
    if dtype == "float64":
        tm = tm.with_data(tm.data.double())
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    tx.save(pt, tm)
    with jax.enable_x64(dtype == "float64"):
        if dtype == "float64":
            jm = jx.BlockMatrix(ids=jm.ids, data=jnp.asarray(np.asarray(tm.data)), nnz=jm.nnz,
                                n_rows=jm.n_rows, n_cols=jm.n_cols, block_size=jm.block_size)
        jx.save(pj, jm)
        from_port = jx.load(pt)
        assert from_port.dtype == jnp.dtype(dtype)
        j_ids, j_data = np.asarray(from_port.ids), np.asarray(from_port.data)
    same_file_arrays(pj, pt)
    from_jax = tx.load(pj, device="cpu")
    assert from_jax.dtype == getattr(torch, dtype)
    nnz = int(tm.nnz)
    for m_ids, m_data in ((from_jax.ids.numpy(), from_jax.data.numpy()), (j_ids, j_data)):
        assert m_ids.shape == (nnz,)
        np.testing.assert_array_equal(m_ids, tm.ids[:nnz].numpy())
        assert m_data.tobytes() == tm.data[:nnz].numpy().tobytes()


def test_npz_bfloat16(tmp_path):
    """numpy has no bfloat16: the JAX package writes the raw 2-byte
    elements (|V2).  The port writes the same bytes and reads them back as
    bfloat16, bitwise."""
    jm, tm = matrix_pair(4, 4, 16, 0.5, 23)
    tb = tm.with_data(tm.data.bfloat16())
    jb = jx.BlockMatrix(ids=jm.ids, data=jm.data.astype(jnp.bfloat16), nnz=jm.nnz,
                        n_rows=jm.n_rows, n_cols=jm.n_cols, block_size=jm.block_size)
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jx.save(pj, jb)
    tx.save(pt, tb)
    same_file_arrays(pj, pt)
    for p in (pj, pt):
        back = tx.load(p, device="cpu")
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.data.view(torch.int16), tb.data.view(torch.int16))
        assert torch.equal(back.ids, tb.ids)
    np.savez(str(tmp_path / "v4.npz"), format_version=1, ids=np.zeros(1, np.int32),
             data=np.zeros((1, 2, 2), "V4"), n_rows=2, n_cols=2, block_size=2)
    with pytest.raises(ValueError, match="V4"):
        tx.load(str(tmp_path / "v4.npz"), device="cpu")
