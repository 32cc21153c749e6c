"""PyTorch port vs the JAX package: the row-panel kernel's options (the
SpAMM skip, the upper-triangle mode and the aligned accumulator) at
b=16, in interpret mode on the JAX side."""

import pytest

from torch_port_helpers import check_rows_spgemm


@pytest.mark.parametrize("option", ["filter", "triu", "acc"])
def test_rows_spgemm_option_matches_jax(option):
    check_rows_spgemm(16, "highest", option)
