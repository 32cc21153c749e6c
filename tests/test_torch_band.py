"""PyTorch port vs the JAX package: the dense-band tier (ops/band.py), as
in tests/test_band.py (all but the API's band residency, which the port
does not have yet).  The same numpy-built inputs go through both
packages on the CPU: panels, ids and probes exactly equal where no
arithmetic runs, products within 1e-5 of max|C| at "highest" and 2e-3
at "default"."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops import band as jbd
from hierarchical_block_sparse_lib_tpu.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.ops import band as tbd

from torch_port_helpers import np_, rel_to_max, to_port

TOL = {"highest": 1e-5, "default": 2e-3}


def _banded_dense(n, w, seed=0):
    r, c, v = gen.banded_coo(n, w, seed=seed)
    return gen.dense_oracle(r, c, v, n), (r, c, v)


def _bands(d, w):
    """(JAX, port) BandMatrix of one dense band, and the panels equal."""
    jb = jbd.band_from_dense(np.asarray(d), w)
    tb = tbd.band_from_dense(torch.from_numpy(d), w)
    np.testing.assert_array_equal(np_(tb.panels), np.asarray(jb.panels))
    assert (tb.n, tb.w, tb.wpad, tb.strips) == (jb.n, jb.w, jb.wpad, jb.strips)
    return jb, tb


def _same_band(tb, jb, tol=0.0):
    assert (tb.n, tb.w, tb.width) == (jb.n, jb.w, jb.width)
    if tol == 0.0:
        np.testing.assert_array_equal(np_(tb.panels), np.asarray(jb.panels))
    else:
        assert rel_to_max(np_(tb.panels), np.asarray(jb.panels)) <= tol


@pytest.mark.parametrize("n,w", [(512, 64), (384, 48), (300, 32)])
def test_band_roundtrip(n, w):
    dA, _ = _banded_dense(n, w)
    _, tb = _bands(dA, w)
    np.testing.assert_array_equal(tbd.band_to_dense(tb).numpy(), dA)


@pytest.mark.parametrize("bb", [16, 128, 256])
def test_band_from_blocks_matches_jax(bb):
    """The one-scatter pack equals the JAX package's, at leaves that
    divide a strip and at a leaf that spans two strips."""
    n, w = 512, 64
    dA, (r, c, v) = _banded_dense(n, w)
    ja = jx.from_coo(r, c, v, n, block_size=bb)
    jb = jbd.band_from_blocks(ja, w)
    tb = tbd.band_from_blocks(to_port(ja), w)
    _same_band(tb, jb)
    np.testing.assert_array_equal(np_(tb.panels), np.asarray(jbd.band_from_dense(dA, w).panels))


@pytest.mark.parametrize("n,w,precision", [(512, 64, "highest"), (384, 48, "highest"),
                                           (384, 48, "default")])
def test_band_mm_matches_jax_and_oracle(n, w, precision):
    dA, _ = _banded_dense(n, w)
    dB, _ = _banded_dense(n, w, seed=1)
    (ja, ta), (jb, tb) = _bands(dA, w), _bands(dB, w)
    jc = jbd.band_mm(ja, jb, precision=precision)
    tc = tbd.band_mm(ta, tb, precision=precision)
    assert tc.w == 2 * w
    _same_band(tc, jc, TOL[precision])
    np.testing.assert_allclose(tbd.band_to_dense(tc).numpy(), dA @ dB, rtol=2e-4, atol=1e-3)


def test_band_mm_chain_and_alpha():
    """Feeding C back in exercises the wpad-multiple-of-128 path."""
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    ja, ta = _bands(dA, w)
    jd = jbd.band_mm(*(2 * [jbd.band_mm(ja, ja, alpha=0.5)]))
    td = tbd.band_mm(*(2 * [tbd.band_mm(ta, ta, alpha=0.5)]))
    _same_band(td, jd, 1e-5)
    np.testing.assert_allclose(
        tbd.band_to_dense(td).numpy(),
        0.25 * np.linalg.matrix_power(dA.astype(np.float64), 4), rtol=2e-4, atol=1e-2,
    )


def test_band_mm_out_w_clamp():
    """out_w discards fill-in beyond the clamp (structural truncation)."""
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    ja, ta = _bands(dA, w)
    tc = tbd.band_mm(ta, ta, out_w=64)
    _same_band(tc, jbd.band_mm(ja, ja, out_w=64), 1e-5)
    assert tc.w == 64
    i, j = np.indices((n, n))
    ref = np.where(np.abs(i - j) <= 64, dA @ dA, 0.0)
    np.testing.assert_allclose(tbd.band_to_dense(tc).numpy(), ref, rtol=2e-4, atol=1e-3)


def test_band_elementwise_ops():
    n, w = 384, 48
    dA, _ = _banded_dense(n, w)
    dB, _ = _banded_dense(n, 32, seed=3)
    (ja, ta), (jb, tb) = _bands(dA, w), _bands(dB, 32)
    _same_band(tbd.band_add(ta, tb, alpha=2.0, beta=-1.0),
               jbd.band_add(ja, jb, alpha=2.0, beta=-1.0), 1e-6)
    s2 = tbd.band_add(tb, ta)  # smaller-wpad first operand
    _same_band(s2, jbd.band_add(jb, ja), 1e-6)
    np.testing.assert_allclose(tbd.band_to_dense(s2).numpy(), dA + dB, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(tbd.band_frob_squared(ta)),
                               float(jbd.band_frob_squared(ja)), rtol=1e-6)
    np.testing.assert_allclose(float(tbd.band_trace(ta)), float(np.trace(dA)), rtol=1e-5)
    np.testing.assert_allclose(float(tbd.band_trace(ta)), float(jbd.band_trace(ja)), rtol=1e-6)
    _same_band(tbd.band_scale(ta, -0.5), jbd.band_scale(ja, -0.5))


def test_band_transpose():
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    ja, ta = _bands(dA, w)
    tt = tbd.band_transpose(ta)
    _same_band(tt, jbd.band_transpose(ja))
    np.testing.assert_array_equal(tbd.band_to_dense(tt).numpy(), dA.T)


@pytest.mark.parametrize("bb", [16, 128])
def test_band_to_blocks(bb):
    n, w = 512, 64
    dA, _ = _banded_dense(n, w)
    ja, ta = _bands(dA, w)
    jm = jbd.band_to_blocks(ja, block_size=bb)
    tm = tbd.band_to_blocks(ta, block_size=bb)
    np.testing.assert_array_equal(np_(tm.ids), np.asarray(jm.ids))
    np.testing.assert_array_equal(np_(tm.data), np.asarray(jm.data))
    assert int(tm.nnz) == int(jm.nnz)
    np.testing.assert_array_equal(tx.to_dense(tm).numpy(), dA)


def test_band_mm_matches_block_path():
    """The same product through the band tier and the port's spgemm."""
    n, w = 512, 64
    dA, (r, c, v) = _banded_dense(n, w)
    ablk = tx.from_coo(r, c, v, n, block_size=128, device="cpu")
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm

    pc, oc = plan_spgemm(ablk, ablk)
    cblk, _ = tx.spgemm(ablk, ablk, pair_cap=pc, out_cap=oc)
    _, ta = _bands(dA, w)
    np.testing.assert_allclose(
        tbd.band_to_dense(tbd.band_mm(ta, ta)).numpy(), tx.to_dense(cblk).numpy(),
        rtol=2e-5, atol=2e-4,
    )


def test_band_probe_and_pair_count():
    """The probe routes a band and declines a random structure, as the
    JAX package's; the structural pair count equals it."""
    n, bw = 512, 48
    r, c, v = gen.banded_coo(n, bw, seed=0)
    ja = jx.from_coo(r, c, v, n, block_size=16)
    w = tbd.band_probe(to_port(ja))
    assert w == jbd.band_probe(ja) and w is not None and w >= bw
    rng = np.random.default_rng(0)
    nb = n // 16
    ids = np.sort(rng.choice(nb * nb, nb * nb // 10, replace=False))
    rr, cc = (ids // nb) * 16, (ids % nb) * 16
    jr = jx.from_coo(rr, cc, np.ones_like(rr, np.float32), n, block_size=16)
    assert tbd.band_probe(to_port(jr)) is None and jbd.band_probe(jr) is None
    for nb_, wb in ((32, 4), (7, 0), (5, 9)):
        assert tbd.band_pair_count(nb_, wb) == jbd.band_pair_count(nb_, wb)
