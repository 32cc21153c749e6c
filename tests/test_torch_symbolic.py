"""PyTorch port vs the JAX package: the SpGEMM symbolic phase and the
fine kernel's row tables must agree exactly (ops/spgemm.py
`spgemm_symbolic`, kernels/pallas_gemm_fine.py `build_tables`)."""

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.kernels.pallas_gemm_fine import (
    build_tables as jax_build_tables,
)
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
    build_tables,
)

from torch_port_helpers import matrix_pair, np_

CASES = {
    "square": ((10, 10, 0.3, 11, (), 0), (10, 10, 0.3, 12, (), 0)),
    "rectangular": ((8, 12, 0.25, 13, (), 2), (12, 6, 0.3, 14, (), 3)),
    # Empty A rows, and B rows that no A column reaches.
    "empty_rows": ((8, 8, 0.3, 15, (1, 4, 5), 0), (8, 8, 0.3, 16, (0, 6), 1)),
}


def operands(case):
    (ar, ac, ad, aseed, aempty, apad), (br, bc, bd, bseed, bempty, bpad) = CASES[case]
    ja, ta = matrix_pair(ar, ac, 16, ad, aseed, aempty, apad)
    jb, tb = matrix_pair(br, bc, 16, bd, bseed, bempty, bpad)
    return ja, ta, jb, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_spgemm_symbolic_matches_jax(case):
    ja, ta, jb, tb = operands(case)
    n_pairs, _ = plan_spgemm(ja, jb)
    pair_cap = n_pairs + 7  # padding entries past `total`
    got = tx.spgemm_symbolic(ta, tb, pair_cap)
    want = jx.spgemm_symbolic(ja, jb, pair_cap)
    names = ("a_idx", "b_idx", "c_id", "total", "raw_total")
    for name, g, w in zip(names, got, want):
        assert np_(g).dtype == np.int32, name
        np.testing.assert_array_equal(np_(g), np_(w), err_msg=name)
    assert int(got[3]) == n_pairs


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_tables_match_jax(case):
    ja, ta, jb, tb = operands(case)
    n_pairs, n_out = plan_spgemm(ja, jb)
    plan = jx.make_fine_plan(ja, jb, n_pairs, n_out + 4, (16, 16))
    out_ids = torch.from_numpy(np.array(plan.out_ids))
    geo = (ja.nb_rows, jb.nb_rows, jb.nb_cols)
    got = build_tables(ta.ids, tb.ids, out_ids, *geo)
    want = jax_build_tables(ja.ids, jb.ids, plan.out_ids, *geo)
    for g, w in zip(got, want):
        assert np_(g).dtype == np.int32
        np.testing.assert_array_equal(np_(g), np_(w))
