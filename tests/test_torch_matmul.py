"""PyTorch port vs the JAX package: the leaf-occupancy counter of
`spgemm` (`a_leaf_occ`/`b_leaf_occ`), the eager front door `matmul`
(ops/matmul.py) and `purify` at 128-wide leaves, which takes no row caps
and so runs on the pair-stream backend.  On the CPU, JAX's "auto" takes
its stream kernel in interpret mode.  Ids, counters, flags and stats are
compared exactly, payloads within 1e-5 of max|C| (iterates within
1e-5*max|X|)."""

import dataclasses

import numpy as np
import pytest

import bench
import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.models import purification as jpur
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.kernels import (
    pallas_gemm_groups,
    pallas_gemm_rows,
    pallas_gemm_stream,
)
from hierarchical_block_sparse_lib_tpu_torch.ops import spgemm as tspgemm
from hierarchical_block_sparse_lib_tpu_torch.ops.matmul import syrk

from torch_port_helpers import assert_same_info, assert_same_matrix, matrix_pair, to_port


@pytest.fixture(scope="module")
def b1_reduced():
    """B1 as bench.py builds it, cut to 512^2 with band 16: leaf-16
    assembly coarsened x8 to 128 with leaf tracking, in both packages."""
    r, c, v = gen.banded_coo(512, 16, seed=0)
    a16 = jx.from_coo(r, c, v, 512, block_size=16)
    fine_pairs, _ = plan_spgemm(a16, a16)
    t16 = to_port(a16)
    ja, jocc = jx.coarsen(a16, 8, cap=jx.plan_coarsen(a16, 8), track_leaves=True)
    ta, tocc = tx.coarsen(t16, 8, cap=tx.plan_coarsen(t16, 8), track_leaves=True)
    return ja, jocc, ta, tocc, fine_pairs


@pytest.mark.parametrize("planned", [False, True])
def test_leaf_multiplies_match_jax_and_plan(b1_reduced, planned, monkeypatch):
    """The leaf counter equals the JAX package's and the leaf-16 host plan,
    on the groups backend, planned or not, and chunked."""
    ja, jocc, ta, tocc, fine_pairs = b1_reduced
    pc, oc = plan_spgemm(ja, ja)
    _, ji = jx.spgemm(ja, ja, pc, oc, a_leaf_occ=jocc, b_leaf_occ=jocc, backend="xla")
    gplan = tx.plan_groups(ta, ta)
    kw = dict(group_caps=gplan.caps, a_leaf_occ=tocc, b_leaf_occ=tocc)
    if planned:
        kw["plan"] = tx.make_plan(ta, ta, pc)
    tc, ti = tx.spgemm(ta, ta, pc, oc, **kw)
    assert_same_info(ti, ji)
    assert int(ti.n_leaf_multiplies) == fine_pairs > 0
    monkeypatch.setattr(tspgemm, "_XLA_PAIR_CHUNK", 3)  # several chunks
    assert int(tx.spgemm(ta, ta, pc, oc, **kw)[1].n_leaf_multiplies) == fine_pairs
    with pytest.raises(ValueError, match="together"):
        tx.spgemm(ta, ta, pc, oc, a_leaf_occ=tocc)


def spy(monkeypatch, module, name, calls):
    """Record in `calls` each call of module.name (a kernel wrapper) made
    through the module attribute."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("case", ["banded", "random"])
def test_matmul_matches_jax(case, monkeypatch):
    """A banded input has under 16 pairs per block row, so `matmul` plans
    groups and "auto" takes the group kernel; a dense 4x4 pattern has 16,
    so it takes the row-panel kernel, as in the reference."""
    if case == "banded":
        ja = bench.banded_block_matrix(512, 80, 128, seed=3)
        ta = to_port(ja)
    else:
        ja, ta = matrix_pair(4, 4, 128, 1.0, 71)
    calls = []
    spy(monkeypatch, pallas_gemm_groups, "groups_spgemm", calls)
    spy(monkeypatch, pallas_gemm_rows, "rows_spgemm", calls)
    jc, ji = jx.matmul(ja, ja, alpha=0.5, transpose_b=True)
    tc, ti = tx.matmul(ta, ta, alpha=0.5, transpose_b=True)
    assert_same_info(ti, ji)
    scale = float(np.abs(np.asarray(jc.data)).max())
    assert_same_matrix(tc, jc, rtol=1e-5, atol=1e-5 * scale)
    assert calls == ["groups_spgemm" if case == "banded" else "rows_spgemm"]
    # syrk: the same counters and blocks; "auto" takes the row-panel
    # kernel with its triu skip (row caps given, groups declined).
    calls.clear()
    tcs, tis = syrk(ta, alpha=0.5)
    jcs, jis = jx.syrk(ja, alpha=0.5)
    assert_same_info(tis, jis)
    assert_same_matrix(tcs, jcs, rtol=1e-5, atol=1e-5 * scale)
    assert calls == ["rows_spgemm"]


def test_purify_b128_matches_jax(monkeypatch):
    """`purify` at 128-wide leaves (no row caps: the stream backend) on a
    small banded input, 3 steps: per-step stats exactly (the trace within
    f32 summation order), the iterate within 1e-5*max|X|."""
    n, b, steps, tau, target = 512, 128, 3, 2e-3, 256.0
    ja = bench.banded_block_matrix(n, 40, b)
    ja = jx.add(jx.scale(ja, 0.05), jx.eye(n, b), beta=0.5, cap=ja.cap + n // b)
    ta = to_port(ja)
    nb = n // b
    kw = dict(pair_cap=nb**3, out_cap=nb * nb, target_trace=target, cap=nb * nb)
    calls = []
    spy(monkeypatch, pallas_gemm_stream, "gather_gemm_accumulate_stream", calls)
    jxf, jst = jpur.purify(ja, steps, tau, **kw)
    txf, tst = tx.purify(ta, steps, tau, **kw)
    assert calls == ["gather_gemm_accumulate_stream"] * steps
    scale = float(np.abs(np.asarray(jxf.data)).max())
    assert_same_matrix(txf, jxf, rtol=1e-5, atol=1e-5 * scale)
    assert len(tst) == len(jst) == steps
    for got, want in zip(tst, jst):
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
            if f.name == "trace":
                np.testing.assert_allclose(g, w, rtol=1e-5)
            else:
                assert g.dtype.kind == w.dtype.kind and g == w, (f.name, g, w)
    assert int(tst[-1].nnz_blocks) < int(tst[-1].nnz_union)  # truncation acts
