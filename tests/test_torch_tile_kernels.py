"""The 128-tile GEMM kernels' contracts on the CPU (gemm_rows.cu,
gemm_stream.cu, gemm_groups.cu through kernels/csrc/gemm_tile.cuh): the
ctypes tables against the C entries, a plain model of the 3xTF32 split
that "highest" runs on the tensor cores, and the two-checkout timer
without a card.

The model: TF32 keeps 10 of float32's 23 fraction bits; `cvt.rna.tf32.f32`
rounds to nearest with ties away from zero, which on float32 bits is "add
half of the dropped part to the magnitude, then clear it".  big = tf32(x),
small = tf32(x - big), and a product is small*big + big*small + big*big,
each pass exact (tf32 products fit in float32) and summed in f32.
"""

import ctypes
import os
import re

import numpy as np
import pytest

from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_groups as pg
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as pr
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_stream as ps

ROWS_TOL = 1e-5  # chip_smoke.py's gate of the 128-tile kernels against their plain versions
CSRC = os.path.join(os.path.dirname(pr.__file__), "csrc")


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x):
    x = np.asarray(x, np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


@pytest.mark.parametrize("source, module", [("gemm_rows.cu", pr), ("gemm_stream.cu", ps),
                                            ("gemm_groups.cu", pg)])
def test_ctypes_signatures_match_the_c_entries(source, module):
    """Each C entry takes as many arguments, pointers, floats and ints in the
    same places, as the wrapper's ctypes table declares (a short table
    would be caught only by a launch on the card)."""
    src = open(os.path.join(CSRC, source)).read()
    entries = dict(re.findall(r"^int (hbsm_\w+)\(([^)]*)\)", src, re.M))
    assert set(entries) == set(module.SIGNATURES)

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_float if param.split()[0] == "float" else ctypes.c_int

    for name, params in entries.items():
        assert [kind(p) for p in params.split(",")] == module.SIGNATURES[name], name


def test_tf32_rounding_model():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 2**-10, 1.0 + 3 * 2**-11, -(1.0 + 2**-11)],
                 np.float32)
    # Ties go away from zero; values on the TF32 grid stay.
    np.testing.assert_array_equal(
        tf32_rna(x), np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 2**-9,
                               -(1.0 + 2**-10)], np.float32))
    assert np.all(tf32_rna(x).view(np.uint32) & np.uint32(0x1FFF) == 0)


@pytest.mark.parametrize("exponent", [-100, -20, -1, 0, 1, 20, 100])
def test_big_plus_small_is_x_to_2_pow_minus_22(exponent):
    rng = np.random.default_rng(exponent + 200)
    x = (rng.uniform(-2.0, 2.0, 4096) * 2.0**exponent).astype(np.float32)
    big, small = tf32_split(x)
    assert np.all(big.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(small.view(np.uint32) & np.uint32(0x1FFF) == 0)
    rel = np.abs((big.astype(np.float64) + small) - x) / np.abs(x.astype(np.float64))
    assert rel.max() <= 2.0**-22


def three_pass_product(a, b):
    """a @ b as the 3xTF32 tier sums it: exact passes, the three added per
    16-deep step into a zeroed f32 partial, each partial added to the f32
    tile (gemm_tile.cuh's order)."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 16):
        s = slice(k, k + 16)
        part = (as_[:, s].astype(np.float64) @ bb[s] + ab[:, s].astype(np.float64) @ bs[s]
                + ab[:, s].astype(np.float64) @ bb[s])
        out += part.astype(np.float32)
    return out


@pytest.mark.parametrize("n_products, scale", [(1, 1.0), (7, 1.0), (7, 1e-3), (28, 30.0)])
def test_three_pass_products_are_within_the_phase_3_gate(n_products, scale):
    """A slot's sum of 128-wide products through the 3xTF32 model is within
    ROWS_TOL (relative to max|C|) of the f64 product; one TF32 pass is not,
    which is why "highest" never runs one."""
    rng = np.random.default_rng(n_products)
    a = (rng.standard_normal((128, 128 * n_products)) * scale).astype(np.float32)
    b = rng.standard_normal((128 * n_products, 128)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    got = np.zeros((128, 128), np.float32)
    for p in range(n_products):
        s = slice(128 * p, 128 * (p + 1))
        got += three_pass_product(a[:, s], b[s])
    err = np.abs(got - exact).max() / np.abs(exact).max()
    assert err <= ROWS_TOL
    one_pass = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)
    assert np.abs(one_pass - exact).max() / np.abs(exact).max() > 10 * ROWS_TOL


def test_time_tile_designs_needs_a_card(capsys):
    """The two-checkout timer of the tile kernels measures nothing off the
    card: it exits 2 and prints no turn."""
    from hierarchical_block_sparse_lib_tpu_torch.scripts import time_tile_designs as ttd

    assert ttd.main(ttd.THIS_ROOT) == 2
    assert "turn" not in capsys.readouterr().out


def test_time_tile_designs_takes_several_roots_and_needs_a_card(tmp_path, capsys):
    """With variant checkouts beside the parent the tile timer still
    measures nothing off the card, and runs no turn."""
    from hierarchical_block_sparse_lib_tpu_torch.scripts import time_tile_designs as ttd

    roots = [str(tmp_path / name) for name in ("parent", "variant")]
    assert ttd.main(*roots) == 2
    assert "turn" not in capsys.readouterr().out
