"""PyTorch port vs the JAX package: representation, assembly, host
planner, generators, chain ops and the no-jax rule
(hierarchical_block_sparse_lib_tpu_torch core/, runtime/, utils/,
ops/basic.py, ops/norms.py, ops/truncate.py, convert.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.core.block_matrix import (
    compact_sorted as jax_compact_sorted,
)
from hierarchical_block_sparse_lib_tpu.runtime import native as jax_native
from hierarchical_block_sparse_lib_tpu_torch.convert import (
    block_matrix_from_numpy,
    to_numpy,
)
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import (
    compact_sorted,
)
from hierarchical_block_sparse_lib_tpu_torch.runtime import native
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import (
    random_block_matrix,
)

from torch_port_helpers import SENTINEL, assert_same_matrix, matrix_pair, np_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("cap", [6, 9, 14])  # overflowing, exact, padded
def test_compact_sorted_matches_jax(cap):
    rng = np.random.default_rng(0)
    ids = rng.choice(np.arange(12, dtype=np.int32), 16)  # duplicates
    ids[[3, 7]] = SENTINEL
    data = rng.standard_normal((16, 4, 4)).astype(np.float32)
    got = compact_sorted(torch.from_numpy(ids), torch.from_numpy(data), cap)
    want = jax_compact_sorted(jnp.asarray(ids), jnp.asarray(data), cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    assert got[1].shape == (cap, 4, 4)
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("b,threshold", [(16, 0.0), (32, 12.0)])
def test_from_dense_to_dense_match_jax(b, threshold):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5 * b + 3, 4 * b - 5)).astype(np.float32)
    x[: 2 * b, b: 3 * b] = 0.0  # zero blocks are not stored
    got = tx.from_dense(x, block_size=b, threshold=threshold)
    want = jx.from_dense(jnp.asarray(x), block_size=b, threshold=threshold)
    assert_same_matrix(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(tx.to_dense(got).numpy(), np.asarray(jx.to_dense(want)))


def test_from_coo_matches_jax():
    rng = np.random.default_rng(2)
    n, b = 100, 16
    rows = rng.integers(0, n, 300).astype(np.int32)
    cols = rng.integers(0, n, 300).astype(np.int32)
    vals = rng.standard_normal(300).astype(np.float32)
    got = tx.from_coo(rows, cols, vals, n, block_size=b, device="cpu")
    want = jx.from_coo(rows, cols, vals, n, block_size=b)
    assert_same_matrix(got, want, rtol=1e-6, atol=1e-6)
    oracle = np.zeros((n, n), np.float64)
    np.add.at(oracle, (rows, cols), vals)
    np.testing.assert_allclose(tx.to_dense(got).numpy(), oracle, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_host_planner_matches_jax(engine):
    cases = [
        (matrix_pair(10, 10, 16, 0.3, 3, pad=2)[1], matrix_pair(10, 10, 16, 0.3, 4)[1]),
        (matrix_pair(8, 12, 16, 0.25, 5, empty_rows=(1,))[1],
         matrix_pair(12, 6, 16, 0.3, 6, empty_rows=(0, 4))[1]),
    ]
    assert native.have_native()
    for a, b in cases:
        args = (np_(a.ids), np_(b.ids), a.nb_cols, b.nb_rows, b.nb_cols)
        want_ex = jax_native.plan_spgemm_ex(*args)
        want = jax_native.plan_spgemm(*args)
        if engine == "native":
            got_ex = native.plan_spgemm_ex(*args)
            got = native.plan_spgemm(*args)
        else:
            got_ex = native.plan_spgemm_ex_numpy(args[0], args[1], args[2], args[4])
            got = native.plan_spgemm_numpy(*args)
        assert tuple(got_ex) == tuple(want_ex)
        assert tuple(got) == tuple(want)
        assert tuple(tx.ops.spgemm.plan_spgemm_ex(a, b)) == tuple(want_ex)
        assert tuple(tx.ops.spgemm.plan_spgemm(a, b)) == tuple(want)


@pytest.mark.parametrize("name,args", [
    ("banded_coo", (70, 5, 3)),
    ("random_block_sparse_coo", (70, 16, 0.2, 4)),
    ("block_ids_banded", (70, 5, 16)),
])
def test_generators_match_jax(name, args):
    from hierarchical_block_sparse_lib_tpu.utils import generators as jax_gen
    from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen

    got, want = getattr(gen, name)(*args), getattr(jax_gen, name)(*args)
    if name == "block_ids_banded":  # a count
        assert got == want
        return
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "banded_coo":
        np.testing.assert_array_equal(gen.dense_oracle(*got, 70), jax_gen.dense_oracle(*want, 70))


def test_random_block_matrix_bit_identical_to_bench():
    sys.path.insert(0, REPO)
    import bench

    want = bench.random_block_matrix(512, 32, 0.05, seed=2)
    got = random_block_matrix(512, 32, 0.05, seed=2, device="cpu")
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert int(got.nnz) == int(want.nnz)
    assert got.ids.dtype == torch.int32


def test_convert_round_trip():
    jm, tm = matrix_pair(6, 5, 16, 0.4, 7, pad=3)
    back = block_matrix_from_numpy(**to_numpy(tm), device="cpu")
    assert_same_matrix(back, jm, rtol=0, atol=0)
    assert to_numpy(jm).keys() == to_numpy(tm).keys()


@pytest.mark.parametrize("cap", [None, 20])
def test_add_scale_match_jax(cap):
    ja, ta = matrix_pair(6, 6, 16, 0.4, 8, pad=2)
    jb, tb = matrix_pair(6, 6, 16, 0.4, 9)
    got, got_ovf = tx.add_with_info(ta, tb, alpha=-0.5, beta=2.0, cap=cap)
    want, want_ovf = jx.add_with_info(ja, jb, alpha=-0.5, beta=2.0, cap=cap)
    assert_same_matrix(got, want)
    assert bool(got_ovf) == bool(want_ovf)
    alpha = torch.tensor(3.0)  # a 0-dim tensor scales like a number
    assert_same_matrix(tx.scale(got, alpha), jx.scale(want, 3.0))


def test_norms_and_truncate_match_jax():
    jm, tm = matrix_pair(6, 6, 16, 0.5, 10, pad=2)
    np.testing.assert_allclose(
        tx.block_frob_squared(tm).numpy(), np.asarray(jx.block_frob_squared(jm)), rtol=1e-5
    )
    np.testing.assert_allclose(float(tx.frob_squared(tm)), float(jx.frob_squared(jm)), rtol=1e-5)
    np.testing.assert_allclose(float(tx.trace(tm)), float(jx.trace(jm)), rtol=1e-5, atol=1e-5)
    # tau halfway between two neighbouring block norms: no comparison
    # is close to a tie.
    norms = np.sort(np.sqrt(np.asarray(jx.block_frob_squared(jm))[: int(jm.nnz)]))
    tau = float(norms[len(norms) // 2] + norms[len(norms) // 2 + 1]) / 2
    assert_same_matrix(tx.truncate(tm, tau), jx.truncate(jm, tau), rtol=0, atol=0)
    got, got_kept = tx.truncate(tm, tau, cap=4)
    want, want_kept = jx.truncate(jm, tau, cap=4)
    assert_same_matrix(got, want, rtol=0, atol=0)
    assert int(got_kept) == int(want_kept) > 4
    # Subtree mode: the level-1 quadrants' norms, far above tau.
    assert_same_matrix(tx.truncate(tm, tau, subtree_level=1), jx.truncate(jm, tau, subtree_level=1),
                       rtol=0, atol=0)


def test_port_imports_no_jax():
    """Every module of the port (found by pkgutil.walk_packages, its scripts
    included) and chip_smoke.py import neither jax nor the JAX package;
    chip_smoke.py's imports inside functions are read from its source."""
    code = """
import ast, importlib, pkgutil, sys
import hierarchical_block_sparse_lib_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
FORBIDDEN = ("jax", "jaxlib", "hierarchical_block_sparse_lib_tpu")
bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
assert not bad, bad
tree = ast.parse(open(chip_smoke.__file__).read())
mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
assert not [m for m in mods if m.split(".")[0] in FORBIDDEN], mods
print(" ".join(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                         capture_output=True, text=True).stdout.split()
    pkg = "hierarchical_block_sparse_lib_tpu_torch."
    for name in ("api", "utils.serialization",
                 "models.purification", "kernels.pallas_gemm_fine", "kernels.pallas_gemm_rows",
                 "kernels.pallas_norms", "kernels.micro_fine", "ops.repack",
                 "scripts.micro_fine_kernel", "scripts.micro_fine_kernel2",
                 "scripts.profile_fine_pieces", "utils.profiling"):
        assert pkg + name in out, name
