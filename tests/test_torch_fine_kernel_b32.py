"""PyTorch port vs the JAX package: the fine kernel module at b=32
(kernels/pallas_gemm_fine.py `fine_spgemm`), flat layout, every precision
tier.  One leaf size per file, so parallel workers share the JAX
interpret-mode kernel runs."""

import pytest

from torch_port_helpers import check_fine_spgemm


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fine_spgemm_matches_jax(precision):
    check_fine_spgemm(32, precision)


def test_fine_spgemm_canonical_layout_matches_jax():
    check_fine_spgemm(32, "highest", layout="canonical")


def test_supported_gates():
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import (
        supported,
    )

    assert all(supported(b, torch.float32) for b in (16, 32, 64))
    assert not supported(48, torch.float32)  # 128 % 48 != 0
    assert not supported(128, torch.float32)  # the b % 128 == 0 kernels' job
    assert not supported(32, torch.float64)
