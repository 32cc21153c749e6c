"""The slice as a whole: the configured B2 chain D = 2*(0.5*A@A + 0.25*A)
(``scripts/acceptance.py::b2_chain`` on the fine engine) at n = 16*32,
leaf 32, 12% block density, through plan_spgemm_ex -> fine_pack ->
make_fine_plan -> fine_matmul(plan=) -> fine_add -> fine_scale ->
fine_unpack in both packages, each against an f64 dense oracle."""

import numpy as np

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.ops.spgemm import (
    plan_spgemm_ex as jax_plan_spgemm_ex,
)
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex

from torch_port_helpers import assert_same_info, assert_same_matrix, matrix_pair


def b2_chain(hbsm, plan_ex, a):
    pc, oc, mbr, mcr = plan_ex(a, a)
    af = hbsm.fine_pack(a)
    plan = hbsm.make_fine_plan(af, af, pc, oc, (mbr, mcr))
    c, info = hbsm.fine_matmul(
        af, af, pair_cap=pc, out_cap=oc, row_caps=(mbr, mcr), alpha=0.5,
        plan=plan,
    )
    d = hbsm.fine_unpack(hbsm.fine_scale(hbsm.fine_add(c, af, beta=0.25), 2.0))
    return d, info, (pc, oc)


def test_b2_chain_matches_jax_and_f64_oracle():
    ja, ta = matrix_pair(16, 16, 32, 0.12, 2)
    jd, jinfo, jcaps = b2_chain(jx, jax_plan_spgemm_ex, ja)
    td, tinfo, tcaps = b2_chain(tx, plan_spgemm_ex, ta)
    assert tcaps == jcaps
    assert_same_info(tinfo, jinfo)
    assert (int(tinfo.n_block_pairs), int(tinfo.n_out_blocks)) == tcaps
    assert not any(bool(getattr(tinfo, f)) for f in (
        "pair_overflow", "out_overflow", "row_overflow", "plan_mismatch"))
    assert_same_matrix(td, jd)
    da = np.asarray(jx.to_dense(ja)).astype(np.float64)
    exact = 2.0 * (0.5 * (da @ da) + 0.25 * da)
    scale = np.abs(exact).max()
    for dense in (tx.to_dense(td).numpy(), np.asarray(jx.to_dense(jd))):
        assert np.abs(dense.astype(np.float64) - exact).max() / scale < 1e-5
