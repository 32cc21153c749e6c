"""PyTorch port vs the JAX package: the row-panel kernel module
(kernels/pallas_gemm_rows.py `rows_spgemm`) at small leaves, every
precision tier.  The JAX kernel runs in interpret mode, which takes any
leaf size; the port's plain version does too."""

import pytest
import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows

from torch_port_helpers import check_rows_spgemm


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_rows_spgemm_matches_jax(b, precision):
    check_rows_spgemm(b, precision)


def test_supported_and_bucket():
    assert pallas_gemm_rows.supported(128, torch.float32)
    assert pallas_gemm_rows.supported(128, torch.bfloat16)
    assert pallas_gemm_rows.supported(256, torch.float32)
    assert pallas_gemm_rows.supported(384, torch.bfloat16)
    assert not pallas_gemm_rows.supported(64, torch.float32)
    assert not pallas_gemm_rows.supported(192, torch.float32)
    assert not pallas_gemm_rows.supported(128, torch.float64)
    assert [pallas_gemm_rows._bucket(n) for n in (0, 1, 8, 9, 13)] == [8, 8, 8, 16, 16]


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor takes the plain version: another device launches
    the kernel or raises."""
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    data = torch.zeros((2, 128, 128), device="meta")
    with pytest.raises(ValueError):
        pallas_gemm_rows.rows_spgemm(ids, data, ids, data, ids, 1, 1, 2, 2, 2, 2)
