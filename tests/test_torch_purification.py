"""The slice as a whole: SP2 purification at 128-wide leaves
(models/purification.py) in both packages, on a banded 512^2 input made
as B3's is (leaf-16 assembly coarsened to 128, shifted): `sp2_step`, and
`profile_purify` -> `plan_purify` -> `purify_scan` planned and unplanned
for 3 steps.  JAX runs its row-panel kernel in interpret mode
(backend="rows"); the port takes its own "auto" dispatch, which picks the
row-panel and norm kernel modules (their plain versions on the CPU)."""

import dataclasses

import numpy as np
import pytest
import torch

import bench
import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.models import purification as jpur
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import banded_block_matrix

from torch_port_helpers import assert_same_matrix

N, B, STEPS, TAU, TARGET = 512, 128, 3, 2e-3, 256.0


@pytest.fixture(scope="module")
def inputs():
    ja = bench.banded_block_matrix(N, 40, B)
    ta = banded_block_matrix(N, 40, B, device="cpu")
    ja = jx.add(jx.scale(ja, 0.05), jx.eye(N, B), beta=0.5, cap=ja.cap + N // B)
    ta = tx.add(tx.scale(ta, 0.05), tx.eye(N, B, device="cpu"), beta=0.5, cap=ta.cap + N // B)
    assert_same_matrix(ta, ja)
    return ja, ta


def test_no_block_norm_near_tau(inputs):
    """Replay the trajectory and check that every pre-truncation block norm
    is more than 1e-3 relative away from tau, so a keep/drop flip between
    the packages would be a fault, not rounding."""
    x = inputs[1]
    prof = tx.profile_purify(x, STEPS, TAU, target_trace=TARGET)
    x = tx.repack(x, prof.cap)
    dropped = 0
    for _ in range(STEPS):
        s = (tx.trace(x) > TARGET).float()
        y, _ = tx.spgemm(x, x, prof.pair_cap, prof.out_cap, row_caps=prof.row_caps,
                         accum=x, alpha=2 * s - 1, beta=2 - 2 * s)
        norms = tx.block_frob_squared(y).sqrt()[y.valid_mask()]
        assert float(torch.min(torch.abs(norms / TAU - 1))) > 1e-3
        x, kept = tx.truncate(y, TAU, cap=prof.cap)
        dropped += int(y.nnz) - int(kept)
    assert dropped > 0  # truncation really acts on this trajectory


def same_stats(got, want):
    """Every stats field exactly; the trace within f32 summation order."""
    for f in dataclasses.fields(want):
        g = getattr(got, f.name).numpy()
        w = np.asarray(getattr(want, f.name))
        if f.name == "trace":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            assert g.dtype.kind == w.dtype.kind, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_sp2_step_matches_jax(inputs):
    ja, ta = inputs
    pc, oc, mbr, mcr = plan_spgemm_ex(ja, ja)
    kw = dict(pair_cap=pc, out_cap=oc + int(ja.nnz), target_trace=TARGET,
              row_caps=(mbr, mcr), cap=ja.cap)
    jy, js = jpur.sp2_step(ja, TAU, backend="rows", **kw)
    ty, ts = tx.sp2_step(ta, TAU, **kw)
    scale = float(np.abs(np.asarray(jy.data)).max())
    assert_same_matrix(ty, jy, rtol=1e-5, atol=1e-5 * scale)
    same_stats(ts, js)


def test_profile_plan_scan_match_jax(inputs):
    ja, ta = inputs
    jprof = jpur.profile_purify(ja, STEPS, TAU, target_trace=TARGET, backend="rows")
    tprof = tx.profile_purify(ta, STEPS, TAU, target_trace=TARGET)
    assert dataclasses.astuple(tprof) == dataclasses.astuple(jprof)
    jplans = jpur.plan_purify(ja, STEPS, TAU, jprof, target_trace=TARGET, backend="rows")
    tplans = tx.plan_purify(ta, STEPS, TAU, tprof, target_trace=TARGET)
    for f in dataclasses.fields(jplans.plans):
        g, w = getattr(tplans.plans, f.name), getattr(jplans.plans, f.name)
        assert (g is None) == (w is None), f.name
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f.name)
    np.testing.assert_array_equal(tplans.expected_ids.numpy(), np.asarray(jplans.expected_ids))
    kw = dict(target_trace=TARGET, **tprof.kwargs())
    jx_u, js_u = jpur.purify_scan(ja, STEPS, TAU, backend="rows", **kw)
    tx_u, ts_u = tx.purify_scan(ta, STEPS, TAU, **kw)
    tx_p, ts_p = tx.purify_scan(ta, STEPS, TAU, plans=tplans, **kw)
    scale = float(np.abs(np.asarray(jx_u.data)).max())
    assert_same_matrix(tx_u, jx_u, rtol=1e-5, atol=1e-5 * scale)
    same_stats(ts_u, js_u)
    same_stats(ts_p, js_u)
    assert torch.equal(tx_p.ids, tx_u.ids) and torch.equal(tx_p.data, tx_u.data)
    assert not bool(ts_p.plan_mismatch.any())
