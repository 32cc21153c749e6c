"""PyTorch port vs the JAX package: the row-panel kernel module at leaves
wider than 128 (b = 256 and 384, which the reference's kernel takes), each
option, and the aligned accumulate through `spgemm` at b = 256.  The JAX
kernel runs in interpret mode; the port takes its plain version on the
CPU."""

import numpy as np
import pytest

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx

from torch_port_helpers import (
    aligned_case,
    assert_same_info,
    assert_same_matrix,
    check_rows_spgemm,
)


@pytest.mark.parametrize("option", [None, "filter", "triu", "acc"])
def test_rows_spgemm_b256_matches_jax(option):
    check_rows_spgemm(256, "highest", option, nb=(3, 4, 3))


def test_rows_spgemm_b384_matches_jax():
    check_rows_spgemm(384, "highest", "filter", nb=(3, 4, 3))


def test_aligned_accumulate_b256_matches_jax():
    """spgemm(backend="rows", accum_aligned=True) at b = 256 against the
    JAX package's: ids exactly, data within 1e-5 of max|C|, the same
    counters."""
    ja, ta, jd, td, (pc, oc, rc) = aligned_case(256, nb=4)
    kw = dict(pair_cap=pc, out_cap=oc, row_caps=rc, backend="rows", beta=0.5,
              accum_aligned=True)
    got, gi = tx.spgemm(ta, ta, accum=td, **kw)
    want, wi = jx.spgemm(ja, ja, accum=jd, **kw)
    scale = float(np.abs(np.asarray(want.data)).max())
    assert_same_matrix(got, want, rtol=1e-5, atol=1e-5 * scale)
    assert_same_info(gi, wi)
