"""PyTorch port vs the JAX package: the fine kernel module at b=64
(kernels/pallas_gemm_fine.py `fine_spgemm`), flat layout, every precision
tier.  One leaf size per file, so parallel workers share the JAX
interpret-mode kernel runs."""

import pytest

from torch_port_helpers import check_fine_spgemm


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_fine_spgemm_matches_jax(precision):
    check_fine_spgemm(64, precision)
