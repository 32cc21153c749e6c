"""The port's purification drivers among themselves: `PurifyEngine`
replans when the input's structure drifts, `purify` (host loop) equals
`purify_scan`, and the unported symmetric variant raises."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import banded_block_matrix

N, B, STEPS, TAU, TARGET = 512, 128, 3, 2e-3, 256.0


def shifted_band(bw):
    x = banded_block_matrix(N, bw, B, device="cpu")
    return tx.add(tx.scale(x, 0.05), tx.eye(N, B, device="cpu"), beta=0.5,
                  cap=x.cap + N // B)


def test_purify_engine_replans_on_drift():
    eng = tx.PurifyEngine(STEPS, TAU, target_trace=TARGET)
    x = shifted_band(40)
    xf, stats = eng.run(x)
    assert eng.n_replans == 1
    assert not bool((stats.plan_mismatch | stats.out_overflow).any())
    # The same structure reuses the plan, and the planned run equals an
    # unplanned scan at the same capacities.
    xf2, _ = eng.run(x.with_data(x.data * 1.0))
    assert eng.n_replans == 1 and torch.equal(xf2.data, xf.data)
    xu, _ = tx.purify_scan(x, STEPS, TAU, target_trace=TARGET, **eng.prof.kwargs())
    assert torch.equal(xu.data, xf.data) and torch.equal(xu.ids, xf.ids)
    # A wider band changes the support: the engine replans before running.
    wide = shifted_band(200)
    assert int(wide.nnz) > int(x.nnz)
    xw, stats = eng.run(wide)
    assert eng.n_replans == 2
    assert not bool((stats.plan_mismatch | stats.pair_overflow).any())
    assert all(v & (v - 1) == 0 for v in (eng.prof.pair_cap, eng.prof.out_cap, eng.prof.cap))


def test_purify_equals_purify_scan():
    x = shifted_band(40)
    prof = tx.profile_purify(x, STEPS, TAU, target_trace=TARGET)
    kw = dict(pair_cap=prof.pair_cap, out_cap=prof.out_cap, cap=prof.cap,
              target_trace=TARGET)
    xs, ss = tx.purify_scan(x, STEPS, TAU, row_caps=prof.row_caps, **kw)
    xp, sp = tx.purify(x, STEPS, TAU, backend="xla", **kw)
    np.testing.assert_array_equal(xp.ids.numpy(), xs.ids.numpy())
    np.testing.assert_allclose(xp.data.numpy(), xs.data.numpy(), rtol=1e-6, atol=1e-6)
    assert [int(s.nnz_blocks) for s in sp] == ss.nnz_blocks.tolist()
    # `purify` takes no row caps: at b=128 its "auto" is the stream
    # kernel's backend, which gives the same trajectory.
    xa, sa = tx.purify(x, STEPS, TAU, **kw)
    np.testing.assert_array_equal(xa.ids.numpy(), xs.ids.numpy())
    np.testing.assert_allclose(xa.data.numpy(), xs.data.numpy(), rtol=1e-6, atol=1e-6)
    assert [int(s.nnz_blocks) for s in sa] == ss.nnz_blocks.tolist()


def test_symmetric_variant_raises():
    """The symmetric step runs unplanned, and raises when handed a plan
    without the mirror map (make_plan(..., sym_mirror=True))."""
    x = shifted_band(40)
    pc, oc = plan_spgemm(x, x)
    y, s = tx.sp2_step(x, TAU, pc, oc + int(x.nnz), symmetric=True)
    dense = tx.to_dense(y)
    assert torch.equal(dense, dense.T) and not bool(s.out_overflow)
    plan = tx.make_plan(x, x, pc, accum_ids=x.ids, out_cap=oc + int(x.nnz))
    with pytest.raises(ValueError, match="sym_mirror"):
        tx.sp2_step(x, TAU, pc, oc + int(x.nnz), symmetric=True, plan=plan)
    assert tx.PurifyEngine(STEPS, TAU, symmetric=True).symmetric
