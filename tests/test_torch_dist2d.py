"""Cannon's algorithm on a 2 x 2 mesh (`parallel.dist2d`) against the JAX
package's `parallel/dist2d.py` on its virtual CPU devices: the same
numpy-built inputs, tiles bitwise, ids and counters exactly, payloads
within 1e-5 of max|C|."""

import jax
import numpy as np
import pytest

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.parallel import dist2d as jd2
from hierarchical_block_sparse_lib_tpu.utils import generators as jgen
from hierarchical_block_sparse_lib_tpu_torch.convert import dist_to_numpy
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist2d

from torch_port_helpers import rel_to_max, to_port, torch_threads


def random_sparse(n, b, density, seed):
    r, c, v = jgen.random_block_sparse_coo(n, b, density, seed=seed)
    return jx.from_coo(r, c, v, n, block_size=b)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def cannon():
    """Inputs on both meshes and the JAX package's Cannon product, once."""
    assert len(jax.devices()) >= 4
    jm, tm = jd2.make_mesh2d(2), dist2d.make_mesh2d(2, device="cpu")
    a, b = random_sparse(256, 16, 0.15, 6), random_sparse(256, 16, 0.15, 7)
    pc, oc = plan_spgemm(a, b)
    kw = dict(pair_cap=max(pc, 1), out_cap=max(oc, 1), alpha=0.5)
    ad, bd = jd2.distribute2d(a, jm), jd2.distribute2d(b, jm)
    want = jd2.dist2d_spgemm(ad, bd, jm, backend="xla", **kw)
    tad, tbd = dist2d.distribute2d(to_port(a), tm), dist2d.distribute2d(to_port(b), tm)
    return dict(jm=jm, tm=tm, a=a, b=b, ad=ad, bd=bd, tad=tad, tbd=tbd, kw=kw, want=want, pc=pc)


def test_distribute2d_bitwise(cannon):
    got, want = dist_to_numpy(cannon["tad"]), dist_to_numpy(cannon["ad"])
    assert cannon["tad"].mesh_shape == (2, 2)
    for k in ("ids", "data", "nnz"):
        np.testing.assert_array_equal(got[k], want[k])
    back, jback = dist2d.undistribute2d(cannon["tad"]), jd2.undistribute2d(cannon["ad"])
    np.testing.assert_array_equal(back.ids.numpy(), np.asarray(jback.ids))
    np.testing.assert_array_equal(back.data.numpy(), np.asarray(jback.data))
    assert int(back.nnz) == int(cannon["a"].nnz)


@pytest.mark.parametrize("backend", ["xla", "auto"])
def test_cannon_matches_jax(cannon, backend):
    c, pairs, ovf = dist2d.dist2d_spgemm(cannon["tad"], cannon["tbd"], cannon["tm"],
                                         backend=backend, **cannon["kw"])
    jc, jpairs, jovf = cannon["want"]
    assert int(pairs) == int(jpairs) == cannon["pc"]
    assert bool(ovf) == bool(jovf) is False
    got, want = dist_to_numpy(c), dist_to_numpy(jc)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["nnz"], want["nnz"])
    assert rel_to_max(got["data"], want["data"]) <= 1e-5


def test_cannon_frob_truncate(cannon):
    tm, jm = cannon["tm"], cannon["jm"]
    np.testing.assert_allclose(float(dist2d.dist2d_frob_squared(cannon["tad"], tm)),
                               float(jd2.dist2d_frob_squared(cannon["ad"], jm)), rtol=1e-6)
    t = dist2d.dist2d_truncate(cannon["tad"], tm, 1e9)
    assert int(dist2d.undistribute2d(t).nnz) == 0
    got = dist_to_numpy(dist2d.dist2d_truncate(cannon["tad"], tm, 10.0))
    want = dist_to_numpy(jd2.dist2d_truncate(cannon["ad"], jm, 10.0))
    for k in ("ids", "data", "nnz"):
        np.testing.assert_array_equal(got[k], want[k])


def test_cannon_needs_square_mesh():
    from hierarchical_block_sparse_lib_tpu_torch.parallel.mesh import make_grid

    rect = make_grid((1, 2), ("r", "c"), device="cpu")
    a = dist2d.distribute2d(to_port(random_sparse(64, 16, 0.3, 1)), rect)
    with pytest.raises(ValueError, match="square"):
        dist2d.dist2d_spgemm(a, a, rect, pair_cap=8, out_cap=8)
    with pytest.raises(ValueError, match="needs p"):
        dist2d.make_mesh2d(device="cpu")
