"""The reference-shaped class (api.py, HierarchicalBlockSparseMatrix) in
both packages: the same numpy-built inputs through the JAX class and the
port's (on the CPU), with ids, structure and counters held equal and
payloads within 1e-5 relative ("highest").  Mirrors tests/test_api.py and
tests/test_band.py::test_band_probe_and_api_residency, and adds the port's
own contracts: deep copies, the plan cache's device and dtype key, the
band counter, band-side `empty()`, and float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu.api as japi
import hierarchical_block_sparse_lib_tpu_torch as tx
import hierarchical_block_sparse_lib_tpu_torch.api as tapi
from hierarchical_block_sparse_lib_tpu.core.block_matrix import Params as JParams
from hierarchical_block_sparse_lib_tpu.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.ops.band import band_pair_count

from torch_port_helpers import assert_same_matrix

JHB = japi.HierarchicalBlockSparseMatrix
THB = tx.HierarchicalBlockSparseMatrix
TOL = dict(rtol=1e-5, atol=1e-5)


def pair_of(n, b, r, c, v, jdtype=jnp.float32, tdtype=torch.float32):
    """(JAX, port) matrices assembled from the same triplets."""
    jm = JHB(JParams(block_size=b, dtype=jdtype))
    jm.resize(n, n)
    jm.assign_from_vectors(r, c, v)
    tm = THB(tx.Params(block_size=b, dtype=tdtype), device="cpu")
    tm.resize(n, n)
    tm.assign_from_vectors(r, c, v)
    return jm, tm


def same(tm, jm, **tol):
    """Block form equal: ids and nnz exactly, payload within tolerance."""
    assert_same_matrix(tm.block_matrix, jm.block_matrix, **(tol or TOL))


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    JHB._plan_cache.clear()
    THB._plan_cache.clear()
    yield


def test_reference_workflow():
    """The reference's flow (test_api.py::test_reference_workflow) in both
    packages: set_params -> resize -> assign -> multiply -> add -> copy ->
    transpose -> truncate -> extract."""
    n = 96
    r, c, v = gen.banded_coo(n, 10, seed=0)
    dA = gen.dense_oracle(r, c, v, n)
    ja, ta = pair_of(n, 16, r, c, v)
    assert ta.get_params() == tx.Params(16)
    assert (ta.get_n_rows(), ta.get_n_cols(), ta.get_depth()) == (
        ja.get_n_rows(), ja.get_n_cols(), ja.get_depth()) == (n, n, 3)
    same(ta, ja, rtol=0, atol=0)
    np.testing.assert_array_equal(ta.to_dense(), dA)
    np.testing.assert_allclose(ta.get_frob_squared(), ja.get_frob_squared(), rtol=1e-6)
    np.testing.assert_allclose(ta.get_trace(), ja.get_trace(), rtol=1e-6)
    assert ta.get_nnz() == ja.get_nnz() and ta.get_nnz_blocks() == ja.get_nnz_blocks()

    for flags in ((False, False), (True, False), (False, True)):
        jc = JHB.multiply(ja, flags[0], ja, flags[1], alpha=0.5)
        tc = THB.multiply(ta, flags[0], ta, flags[1], alpha=0.5)
        same(tc, jc)
        assert tc.no_of_block_multiplies == jc.no_of_block_multiplies > 0
        assert tc._band is None and jc._band is None  # the window covers n
    s = THB.add(ta, ta, alpha=1.0, beta=2.0)
    same(s, JHB.add(ja, ja, alpha=1.0, beta=2.0))
    np.testing.assert_allclose(s.to_dense(), 3 * dA, rtol=1e-6)

    a2 = ta.copy()
    a2.rescale(0.5)
    np.testing.assert_allclose(a2.to_dense(), 0.5 * dA, rtol=1e-6)
    np.testing.assert_array_equal(ta.to_dense(), dA)  # copy isolated
    same(ta.get_transpose(), ja.get_transpose(), rtol=0, atol=0)

    jc = JHB.multiply(ja, False, ja, False)
    tc = THB.multiply(ta, False, ta, False)
    jc.frob_block_trunc(30.0)
    tc.frob_block_trunc(30.0)
    same(tc, jc)
    assert 0 < tc.get_nnz_blocks() < THB.multiply(ta, False, ta, False).get_nnz_blocks()
    tc.frob_block_trunc(1e6)
    assert tc.get_nnz_blocks() == 0 and tc.empty()

    # Export in the JAX package's element order, bitwise.
    for got, want in zip(ta.get_all_values(), ja.get_all_values()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ta.get_values(r[:10], c[:10]), v[:10])
    assert ta.get_values([0], [n - 1])[0] == 0 == ja.get_values([0], [n - 1])[0]


def test_api_errors():
    """test_api.py::test_api_errors, and the device rule: without a card
    the default constructor raises; device='cpu' builds on the CPU."""
    a = THB(device="cpu")
    with pytest.raises(RuntimeError):
        a.get_n_rows()
    assert a.empty() and JHB().empty()
    a.resize(32)
    assert a.empty() and a.device == torch.device("cpu")
    with pytest.raises(RuntimeError):
        a.set_params(tx.Params(16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            THB()


def test_save_load_roundtrip(tmp_path):
    """test_api.py::test_save_load_roundtrip on the port: round trip,
    capacity override and dtype cast."""
    n = 96
    r, c, v = gen.banded_coo(n, 10, seed=3)
    m = tx.from_coo(r, c, v, n, block_size=16, device="cpu")
    p = str(tmp_path / "m.npz")
    tx.save(p, m)
    m2 = tx.load(p, device="cpu")
    assert torch.equal(m2.ids, m.ids) and torch.equal(m2.data, m.data)
    assert int(m2.nnz) == int(m.nnz)
    m3 = tx.load(p, cap=int(m.nnz) + 7, device="cpu")
    assert m3.cap == int(m.nnz) + 7
    assert torch.equal(tx.to_dense(m3), tx.to_dense(m))
    m4 = tx.load(p, dtype=torch.float64, device="cpu")
    assert m4.dtype == torch.float64
    assert torch.equal(tx.to_dense(m4), tx.to_dense(m).double())
    with pytest.raises(ValueError, match="cap"):
        tx.load(p, cap=1, device="cpu")


def test_multiply_plan_cache(monkeypatch):
    """test_api.py::test_multiply_plan_cache: one host plan per structure,
    exact results on a hit (plan_mismatch false), a replan on a new
    structure; and the key holds the device and dtype, so a float64
    operand of the same structure never takes the float32 plan."""
    n, b = 96, 16
    r, c, v = gen.banded_coo(n, 10, seed=5)
    calls = []
    orig = tapi.plan_spgemm_ex

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tapi, "plan_spgemm_ex", counting)

    def mk(vals, dtype=torch.float32):
        m = THB(tx.Params(block_size=b, dtype=dtype), device="cpu")
        m.resize(n)
        m.assign_from_vectors(r, c, vals)
        return m

    a = mk(v)
    c1 = THB.multiply(a, False, a, False)
    assert len(calls) == 1
    a2 = mk(v * 1.5)
    c2 = THB.multiply(a2, False, a2, False)
    assert len(calls) == 1
    d = a2.to_dense().astype(np.float64)
    np.testing.assert_allclose(c2.to_dense(), d @ d, **TOL)
    (key,) = THB._plan_cache
    assert "cpu" in key and torch.float32 in key
    plan = THB._plan_cache[key][0]
    assert plan.a_ids.device == torch.device("cpu")
    a64 = mk(v.astype(np.float64), torch.float64)
    c64 = THB.multiply(a64, False, a64, False)
    assert len(calls) == 2 and c64.block_matrix.dtype == torch.float64
    r3, c3 = np.concatenate([r, [0]]), np.concatenate([c, [n - 1]])
    b3 = THB(tx.Params(block_size=b), device="cpu")
    b3.resize(n)
    b3.assign_from_vectors(r3, c3, np.concatenate([v, [2.0]]).astype(np.float32))
    THB.multiply(b3, False, b3, False)
    assert len(calls) == 3
    assert c1.no_of_block_multiplies == c2.no_of_block_multiplies


def band_pairs(n=512, bw=48):
    r, c, v = gen.banded_coo(n, bw, seed=0)
    ja, ta = pair_of(n, 16, r, c, v)
    return r, c, v, ja, ta


def test_band_probe_and_api_residency():
    """test_band.py::test_band_probe_and_api_residency in both packages:
    the multiply stays band-resident, matches the f64 oracle and the JAX
    class, and band-side reductions do not materialize."""
    n = 512
    r, c, v, ja, ta = band_pairs(n)
    dA = gen.dense_oracle(r, c, v, n).astype(np.float64)
    jp = JHB.multiply(ja, False, ja, False)
    tp = THB.multiply(ta, False, ta, False)
    assert tp._band is not None and tp._m is None and jp._m is None
    assert tp._band.w == jp._band.w
    np.testing.assert_allclose(tp.to_dense(), dA @ dA, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp.to_dense(), jp.to_dense(), **TOL)
    tp2 = THB.multiply(ta, False, ta, False)
    got = tp2.get_frob_squared()
    assert tp2._m is None
    np.testing.assert_allclose(got, float(((dA @ dA) ** 2).sum()), rtol=1e-4)
    np.testing.assert_allclose(tp2.get_trace(), np.trace(dA @ dA), rtol=1e-4)
    tp2.rescale(2.0)
    assert tp2._m is None
    np.testing.assert_allclose(tp2.to_dense(), 2.0 * (dA @ dA), rtol=1e-4, atol=1e-4)
    sq = THB.multiply(tp, False, tp, False)
    jsq = JHB.multiply(jp, False, jp, False)
    assert sq._band is not None and sq._m is None
    np.testing.assert_allclose(sq.to_dense(), jsq.to_dense(), rtol=1e-5, atol=1e-3)
    # Materializing emits the band support, as in the JAX package.
    assert tp.get_nnz_blocks() == jp.get_nnz_blocks()
    same(tp, jp)


def test_band_counter_is_the_block_paths():
    """Decision (a): the band path counts at block halfwidth
    ceil((w+1)/b) - 1.  On a band whose blocks are all stored that is the
    block path's n_block_pairs; the JAX package's (w+b-1)//b counts one
    block diagonal more.  On a chained band product, whose w over-covers
    its content, the count lies between the block path's on the same
    product and the JAX package's."""
    n, b = 512, 16
    _, _, _, ja, ta = band_pairs(n)
    nb = n // b
    a = ta.block_matrix
    ids = a.ids[: int(a.nnz)].numpy()
    wb = int(np.abs(ids // nb - ids % nb).max())
    assert ids.size == nb * (2 * wb + 1) - wb * (wb + 1)  # every band block stored
    ca, info = tx.matmul(a, a)
    tp = THB.multiply(ta, False, ta, False)
    jp = JHB.multiply(ja, False, ja, False)
    assert tapi.band_block_halfwidth(ta._band.w, b) == wb
    assert tp.no_of_block_multiplies == int(info.n_block_pairs) == band_pair_count(nb, wb)
    assert jp.no_of_block_multiplies == band_pair_count(nb, wb + 1) > tp.no_of_block_multiplies
    sq = THB.multiply(tp, False, tp, False)
    jsq = JHB.multiply(jp, False, jp, False)
    step = sq.no_of_block_multiplies - tp.no_of_block_multiplies
    jstep = jsq.no_of_block_multiplies - jp.no_of_block_multiplies
    block_step = int(tx.matmul(ca, ca)[1].n_block_pairs)
    assert block_step <= step < jstep
    assert step == band_pair_count(nb, tapi.band_block_halfwidth(tp._band.w, b))


def test_band_result_not_regated_and_empty_from_band():
    """Decisions (b) and (c): a band-resident product is kept in band form
    (it is not probed again), as in the JAX package; `empty()` answers
    from the band side without materializing, with the JAX answer."""
    _, _, _, ja, ta = band_pairs()
    tp = THB.multiply(ta, False, ta, False)
    jp = JHB.multiply(ja, False, ja, False)
    assert tp._band_w == tp._band.w == jp._band_w  # no probe of the product
    assert tp.empty() is False and tp._m is None
    assert jp.empty() is False  # the JAX class materializes to answer
    assert tp.get_n_rows() == 512 and tp._m is None


def test_copy_is_deep():
    """copy() clones the tensors: in-place writes, rescale and
    frob_block_trunc on the copy leave the original as it was, for the
    block form and for a band-resident copy."""
    n = 96
    r, c, v = gen.banded_coo(n, 10, seed=7)
    _, ta = pair_of(n, 16, r, c, v)
    before = ta.to_dense().copy()
    cp = ta.copy()
    assert cp._m.data.data_ptr() != ta._m.data.data_ptr()
    assert cp._m.ids.data_ptr() != ta._m.ids.data_ptr()
    cp._m.data.mul_(3.0)  # in place, on the copy only
    cp.rescale(0.5)
    np.testing.assert_array_equal(ta.to_dense(), before)
    cp2 = ta.copy()
    cp2.frob_block_trunc(1e6)
    assert cp2.empty() and not ta.empty()
    np.testing.assert_array_equal(ta.to_dense(), before)

    _, _, _, _, tb = band_pairs()
    prod = THB.multiply(tb, False, tb, False)
    ref = prod.to_dense().copy()
    prod = THB.multiply(tb, False, tb, False)  # band-resident again
    bc = prod.copy()
    assert bc._band.panels.data_ptr() != prod._band.panels.data_ptr()
    bc._band.panels.zero_()
    bc.rescale(-1.0)
    bc.frob_block_trunc(0.0)
    np.testing.assert_array_equal(prod.to_dense(), ref)


def test_from_block_matrix_and_counters_carry():
    """from_block_matrix wraps a functional matrix; a product chain
    carries A's count plus each multiply's pairs, as the JAX class does."""
    rng = np.random.default_rng(11)
    d = (rng.standard_normal((128, 128)) * (rng.random((128, 128)) < 0.2)).astype(np.float32)
    jm = JHB.from_block_matrix(jx.from_dense(d, block_size=16))
    tm = THB.from_block_matrix(tx.from_dense(torch.from_numpy(d), block_size=16))
    assert tm.device == torch.device("cpu") and tm.get_params() == tx.Params(16)
    jc, tc = jm, tm
    for _ in range(3):
        jc = JHB.multiply(jc, False, jm, False)
        tc = THB.multiply(tc, False, tm, False)
        assert tc.no_of_block_multiplies == jc.no_of_block_multiplies
        same(tc, jc, rtol=1e-5, atol=1e-4)


def test_class_bfloat16_reads_widen():
    """numpy has no bfloat16: the class's host reads of a bf16 matrix
    come back as float32, exactly, and the empty export has that dtype."""
    n = 32
    r, c, v = gen.banded_coo(n, 3, seed=2)
    m = THB(tx.Params(16, torch.bfloat16), device="cpu")
    m.resize(n)
    assert m.get_all_values()[2].dtype == np.float32
    m.assign_from_vectors(r, c, v)
    rows, cols, vals = m.get_all_values()
    want = torch.from_numpy(v).bfloat16().float().numpy()
    assert vals.dtype == np.float32
    np.testing.assert_array_equal(m.get_values(rows, cols), vals)
    dense = np.zeros((n, n), np.float32)
    dense[r, c] = want
    np.testing.assert_array_equal(m.to_dense(), dense)
    np.testing.assert_array_equal(dense[rows, cols], vals)


def test_class_float64():
    """Params(dtype=torch.float64): the class multiplies on the torch
    float64 path ("xla"), against the JAX class under x64 and an f64
    oracle within 1e-12."""
    n = 96
    r, c, v = gen.banded_coo(n, 10, seed=9, dtype=np.float64)
    dA = gen.dense_oracle(r, c, v, n)
    with jax.enable_x64(True):
        ja, ta = pair_of(n, 16, r, c, v, jnp.float64, torch.float64)
        jc = JHB.multiply(ja, False, ja, True, alpha=0.25)
        tc = THB.multiply(ta, False, ta, True, alpha=0.25)
        jt = np.asarray(jx.to_dense(jc.block_matrix))
    assert tc.block_matrix.dtype == torch.float64
    assert tc.no_of_block_multiplies == jc.no_of_block_multiplies
    np.testing.assert_array_equal(tc.block_matrix.ids.numpy(), np.asarray(jc.block_matrix.ids))
    np.testing.assert_allclose(tc.to_dense(), 0.25 * dA @ dA.T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tc.to_dense(), jt, rtol=1e-12, atol=1e-12)
    assert ta.get_all_values()[2].dtype == np.float64
