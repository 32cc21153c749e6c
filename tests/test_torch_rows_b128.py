"""PyTorch port vs the JAX package: the row-panel kernel module at the
kernel's own leaf size, b=128, and its bf16 storage."""

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_rows import (
    rows_spgemm,
)

from torch_port_helpers import check_rows_spgemm, matrix_pair


def test_rows_spgemm_b128_matches_jax():
    check_rows_spgemm(128, "highest", nb=(4, 5, 3))


def test_rows_spgemm_bf16_is_exact_products():
    """bf16 storage: every tier gives the f32 products of the stored
    values (one pass is operand-exact), as the reference's dispatch."""
    _, ta = matrix_pair(3, 3, 128, 0.6, 5)
    ids = ta.ids
    out_ids = torch.arange(9, dtype=torch.int32)
    a16 = ta.data.bfloat16()
    geo = (3, 3, 3, 9, 3, 3)
    want = rows_spgemm(ids, a16.float(), ids, a16.float(), out_ids, *geo)
    for prec in ("highest", "high", "default"):
        got = rows_spgemm(ids, a16, ids, a16, out_ids, *geo, precision=prec)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
