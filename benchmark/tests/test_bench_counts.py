"""counts.py's pairs, FLOPs and bytes against hand counts."""

import numpy as np

from benchmark import counts, gen


def test_pairs_and_support_by_hand():
    # 3x3 grid.  A holds (0,0), (0,1), (2,1); B holds (0,2), (1,0), (1,2).
    a = counts.block_mask([0, 1, 7], 3)
    b = counts.block_mask([2, 3, 5], 3)
    # Column 0 of A (1 block) x row 0 of B (1), column 1 of A (2) x row 1 of B (2).
    assert counts.pairs(a, b) == 1 * 1 + 2 * 2
    # C's support: (0,2) from k=0 and k=1, (0,0) from k=1, (2,0), (2,2).
    assert counts.mask_ids(counts.product_mask(a, b)).tolist() == [0, 2, 6, 8]


def test_flops_bytes_and_least_time():
    assert counts.gemm_flops(5, 32) == 5 * 2 * 32**3
    assert counts.block_bytes(3, 32) == 3 * 32 * 32 * 4
    # 1 GFLOP at 1 TFLOP/s against 1 GB at 1 TB/s: both 1 ms.
    assert counts.least_seconds(1e9, 1e9, 1e12, 1e12) == 1e-3
    assert counts.least_seconds(2e9, 1e9, 1e12, 1e12) == 2e-3


def test_random_ids_match_the_generator_arithmetic():
    ids = gen.random_block_ids(16384, 32, 0.05, gen.host_rng(3))
    assert ids.size == round(0.05 * 512 * 512) == 13107
    assert np.all(np.diff(ids) > 0) and ids[-1] < 512 * 512
