"""PyTorch port vs the JAX package: the pair-stream backend
(kernels/pallas_gemm_stream.py, `spgemm(backend="pallas")`) and the v1
chunked gather-GEMM-accumulate it serves (kernels/pallas_gemm.py), as in
tests/test_pallas_kernels.py.  The JAX kernels run in interpret mode; on
the CPU the port's wrappers take their plain versions.  Ids and counters
are compared exactly, payloads within 1e-5 of max|C|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.core.block_matrix import SENTINEL as JSENT
from hierarchical_block_sparse_lib_tpu.kernels.pallas_gemm import (
    gather_gemm_accumulate as jax_gga,
)
from hierarchical_block_sparse_lib_tpu.kernels.pallas_gemm_stream import (
    gather_gemm_accumulate_stream as jax_stream,
)
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm, pallas_gemm_stream

from torch_port_helpers import assert_same_info, assert_same_matrix, matrix_pair, to_port


def same(tc, ti, jc, ji):
    assert_same_info(ti, ji)
    scale = float(np.abs(np.asarray(jc.data)).max())
    assert_same_matrix(tc, jc, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("b", [8, 16])
def test_pallas_spgemm_matches_jax(b):
    r, c, v = gen.banded_coo(128, 6, seed=0)
    ja = jx.from_coo(r, c, v, 128, block_size=b)
    ta = to_port(ja)
    pc, oc = plan_spgemm(ja, ja)
    jc, ji = jx.spgemm(ja, ja, pair_cap=pc, out_cap=oc, backend="pallas")
    tc, ti = tx.spgemm(ta, ta, pair_cap=pc, out_cap=oc, backend="pallas")
    same(tc, ti, jc, ji)
    dense = gen.dense_oracle(r, c, v, 128).astype(np.float64)
    np.testing.assert_allclose(tx.to_dense(tc).numpy(), dense @ dense, rtol=2e-4, atol=1e-3)


def test_pallas_spgemm_with_padding_pairs():
    """pair_cap above the pair count: the padding pairs' trash slot must
    not reach the output, and the tail slots stay zero."""
    r, c, v = gen.random_block_sparse_coo(64, 8, 0.3, seed=1)
    ja = jx.from_coo(r, c, v, 64, block_size=8)
    ta = to_port(ja)
    pc, oc = plan_spgemm(ja, ja)
    kw = dict(pair_cap=pc * 2 + 7, out_cap=oc + 3, backend="pallas")
    jc, ji = jx.spgemm(ja, ja, **kw)
    tc, ti = tx.spgemm(ta, ta, **kw)
    same(tc, ti, jc, ji)
    assert not tc.data[oc:].any()


def test_pallas_empty():
    ja = jx.empty(64, 64, 8, cap=4)
    ta = to_port(ja)
    jc, ji = jx.spgemm(ja, ja, pair_cap=4, out_cap=4, backend="pallas")
    tc, ti = tx.spgemm(ta, ta, pair_cap=4, out_cap=4, backend="pallas")
    same(tc, ti, jc, ji)
    assert not tc.data.any()


def stream_inputs(b=128, extra_pairs=5):
    """A c-sorted pair list of a 3x2 by 2x3 block product at leaf b, with
    padding pairs, as spgemm builds it: (ja, jb, ta, tb, a_idx, b_idx,
    seg, out_cap) with numpy index arrays."""
    ja, ta = matrix_pair(3, 2, b, 0.7, 61, pad=1)
    jb, tb = matrix_pair(2, 3, b, 0.7, 62)
    pc, oc = plan_spgemm(ja, jb)
    a_idx, b_idx, c_id, _, _ = (np.array(x) for x in jx.spgemm_symbolic(ja, jb, pc + extra_pairs))
    first = np.concatenate([[True], c_id[1:] != c_id[:-1]])
    seg = np.where(c_id != JSENT, np.cumsum(first) - 1, oc).astype(np.int32)
    return ja, jb, ta, tb, a_idx, b_idx, seg, oc


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_stream_kernel_module_matches_jax(precision):
    """The kernel module at b=128 against the JAX kernel in interpret
    mode.  The reference leaves slots no pair visits undefined, so the
    comparison is over the visited slots; the port's are all visited
    here.  At "default" JAX gets bf16-rounded operands: its interpret mode
    does not round them."""
    ja, jb, ta, tb, a_idx, b_idx, seg, oc = stream_inputs()
    jad, jbd = ja.data, jb.data
    if precision == "default":
        jad, jbd = (x.astype(jnp.bfloat16).astype(jnp.float32) for x in (jad, jbd))
    want = np.asarray(jax_stream(jad, jbd, jnp.asarray(a_idx), jnp.asarray(b_idx),
                                 jnp.asarray(seg), oc, precision=precision))
    got = pallas_gemm_stream.gather_gemm_accumulate_stream(
        ta.data, tb.data, torch.from_numpy(a_idx), torch.from_numpy(b_idx),
        torch.from_numpy(seg), oc, precision=precision,
    ).numpy()
    visited = np.unique(seg[seg < oc])
    assert visited.size == oc
    err = np.abs(got[visited] - want[visited]).max() / np.abs(want[visited]).max()
    assert err <= 1e-5, err


def test_stream_kernel_module_cin_and_empty():
    """Every slot starts from `cin`; a slot no pair reaches keeps it, and
    an empty pair list returns `cin` (or zeros) as it is."""
    _, _, ta, tb, a_idx, b_idx, seg, oc = stream_inputs()
    gga = pallas_gemm_stream.gather_gemm_accumulate_stream
    seg = np.where(seg == oc, oc + 2, seg)  # padding pairs to the new trash slot
    args = (ta.data, tb.data, torch.from_numpy(a_idx), torch.from_numpy(b_idx),
            torch.from_numpy(seg), oc + 2)  # two slots no pair reaches
    rng = np.random.default_rng(63)
    cin = torch.from_numpy(rng.standard_normal((oc + 2, 128, 128)).astype(np.float32))
    plain = gga(*args)
    with_cin = gga(*args, cin=cin)
    torch.testing.assert_close(with_cin, plain + cin, rtol=1e-6, atol=1e-5)
    assert not plain[oc:].any() and torch.equal(with_cin[oc:], cin[oc:])
    none = torch.zeros(0, dtype=torch.int32)
    assert not gga(ta.data, tb.data, none, none, none, 4).any()
    assert torch.equal(gga(ta.data, tb.data, none, none, none, oc + 2, cin=cin), cin)


@pytest.mark.parametrize("chunk", [23, 64])
def test_gather_gemm_accumulate_chunked_matches_jax(chunk):
    """The v1 chunked call: segments spanning chunk boundaries accumulate
    exactly through the carry-in, padding pairs included; chunked equals
    one chunk, and slots no pair visits are zero."""
    r, c, v = gen.random_block_sparse_coo(96, 8, 0.3, seed=5)
    ja = jx.from_coo(r, c, v, 96, block_size=8)
    ta = to_port(ja)
    pc, oc = plan_spgemm(ja, ja)
    assert pc > 2 * chunk
    a_idx, b_idx, c_id, _, _ = jx.spgemm_symbolic(ja, ja, pc + 5)
    first = jnp.concatenate([jnp.ones((1,), bool), c_id[1:] != c_id[:-1]])
    seg = jnp.where(c_id != JSENT, jnp.cumsum(first) - 1, oc).astype(jnp.int32)
    want = np.asarray(jax_gga(ja.data, ja.data, a_idx, b_idx, seg, oc, chunk=chunk))
    # One more slot than the product has, which no pair visits.
    seg_t = jnp.where(seg == oc, oc + 1, seg)
    targs = (ta.data, ta.data) + tuple(torch.from_numpy(np.array(x)) for x in (a_idx, b_idx, seg_t))
    got = pallas_gemm.gather_gemm_accumulate(*targs, oc + 1, chunk=chunk)
    single = pallas_gemm.gather_gemm_accumulate(*targs, oc + 1, chunk=pc + 5)
    np.testing.assert_allclose(got[:oc].numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    torch.testing.assert_close(got, single, rtol=1e-6, atol=1e-6)
    assert not got[oc].any()  # a slot no pair visits
    torch.testing.assert_close(
        got, pallas_gemm.gather_gemm_accumulate_reference(*targs, oc + 1), rtol=1e-6, atol=1e-6
    )
