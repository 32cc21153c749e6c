"""The router's aligned decision and its aligned routed product at leaves
wider than 128, against the JAX package on its 8 virtual CPU devices.

`freeze_route_plan` takes the aligned regime by the reference's row-panel
rule (`pallas_gemm_rows.reference_rows_rule`: b % 128 == 0, not float64,
a TPU VMEM tier that fits the plan's row caps), so the frozen plan is the
JAX package's at every leaf and type: at b = 256 and 384 both align, at
b = 512 only bf16 does, and at b = 128 f32 row caps past the tier turn it
off.
Ids exactly; payloads within 1e-5 of max|C|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.parallel import dist as jdist, route as jroute
from hierarchical_block_sparse_lib_tpu_torch.convert import dist_to_numpy
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route

from torch_port_helpers import assert_same_plan, rel_to_max, to_port, torch_threads

P = 8
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= P
    return jdist.make_mesh(P), dist.make_mesh(P, device="cpu")


def band_ids(nb, hw=1):
    return np.array([i * nb + j for i in range(nb) for j in range(nb) if abs(i - j) <= hw],
                    np.int32)


def arrow_ids(nb):
    """Block row 0 and block column 0 full, and the diagonal: every C row
    is full, and B's row 0 reaches every shard."""
    return np.array(sorted({i * nb + j for i in range(nb) for j in range(nb)
                            if i == 0 or j == 0 or i == j}), np.int32)


def zero_pair(ids, nb, b, dtype):
    """(JAX, port) matrices with these ids and zero blocks: the aligned
    decision reads only the structure."""
    geo = dict(n_rows=nb * b, n_cols=nb * b, block_size=b)
    n = ids.size
    ja = jx.BlockMatrix(ids=jnp.asarray(ids), data=jnp.zeros((n, b, b), jnp.dtype(dtype)),
                        nnz=jnp.asarray(n, jnp.int32), **geo)
    ta = BlockMatrix(ids=torch.from_numpy(ids), data=torch.zeros((n, b, b), dtype=getattr(
        torch, dtype)), nnz=torch.tensor(n, dtype=torch.int32), **geo)
    return ja, ta


def decisions(meshes, ids, nb, b, dtype):
    jm, tm = meshes
    ja, ta = zero_pair(ids, nb, b, dtype)
    ad, tad = jdist.distribute(ja, jm), dist.distribute(ta, tm)
    jplan, plan = jroute.plan_route(ad, ad, P), route.plan_route(tad, tad, P)
    assert_same_plan(plan, jplan)
    got = route.freeze_route_plan(tad, tad, plan).aligned
    want = jroute.freeze_route_plan(ad, ad, jplan).aligned
    return got, want, len(plan.stages)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [128, 256, 384, 512])
def test_aligned_decision_matches_jax(meshes, b, dtype):
    """A banded 16 x 16-block matrix (3 kept stages): the port's default
    decision equals the JAX package's at every leaf and type.  Both align
    up to b = 384, and at b = 512 only bf16 fits the reference's tiers
    (an f32 b = 512 panel does not)."""
    got, want, n_stages = decisions(meshes, band_ids(16), 16, b, dtype)
    assert n_stages == 3
    assert got == want == (b <= 384 or dtype == "bfloat16")


@pytest.mark.parametrize("dtype,aligned", [("float32", False), ("bfloat16", True)])
def test_aligned_decision_row_caps_past_the_tier(meshes, dtype, aligned):
    """At b = 128 an arrow matrix (B row 0 and every C row 112 blocks
    wide, 8 kept stages): in f32 its row caps pass the reference kernel's
    VMEM tiers, so neither package aligns; bf16 panels take half the
    bytes and fit its last tier, so both do."""
    got, want, n_stages = decisions(meshes, arrow_ids(112), 112, 128, dtype)
    assert n_stages == 8
    assert got == want == aligned


def test_routed_aligned_b256_matches_jax(meshes):
    """The port's routed product at b = 256 in the aligned regime (the
    row-panel kernel's plain version with the aligned accumulate, every
    stage) against the JAX package's routed product on "xla": ids
    exactly per shard, data within 1e-5."""
    jm, tm = meshes
    nb, b = 8, 256
    rng = np.random.default_rng(11)
    ids = band_ids(nb)
    data = (rng.standard_normal((ids.size, b, b)) / b).astype(np.float32)
    ja = jx.BlockMatrix(ids=jnp.asarray(ids), data=jnp.asarray(data),
                        nnz=jnp.asarray(ids.size, jnp.int32), n_rows=nb * b, n_cols=nb * b,
                        block_size=b)
    ad, tad = jdist.distribute(ja, jm), dist.distribute(to_port(ja), tm)
    plan = route.plan_route(tad, tad, P)
    frozen = route.freeze_route_plan(tad, tad, plan)
    assert frozen.aligned and len(plan.stages) == 3
    c, st = route.dist_spgemm_routed(tad, tad, tm, frozen)
    jc, jst = jroute.dist_spgemm_routed(ad, ad, jm, jroute.plan_route(ad, ad, P),
                                        backend="xla")
    for k in ("n_block_pairs", "overflow", "plan_mismatch"):
        assert int(st[k]) == int(jst[k]), k
    got, want = dist_to_numpy(c), dist_to_numpy(jc)
    np.testing.assert_array_equal(got["nnz"], want["nnz"])
    for d in range(P):
        n = int(want["nnz"][d])
        np.testing.assert_array_equal(got["ids"][d][:n], want["ids"][d][:n])
    assert rel_to_max(got["data"], want["data"]) <= TOL
