"""The port's mesh, its collectives and the 1-D ring (`parallel.mesh`,
`parallel.dist`) against the JAX package's `parallel/dist.py` on its 8
virtual CPU devices.  The port runs 8 logical shards on the CPU; inputs
are made once with numpy and handed to both packages.  Ids, nnz, pair
counts and overflow flags exactly; payloads within 1e-5 of max|C|.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.parallel import dist as jdist
from hierarchical_block_sparse_lib_tpu.utils import generators as jgen
from hierarchical_block_sparse_lib_tpu_torch.convert import (
    dist_block_matrix_from_numpy,
    dist_to_numpy,
)
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, mesh as tmesh

from torch_port_helpers import rel_to_max, to_port, torch_threads

P = 8
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) >= P, "conftest must provide 8 CPU devices"
    return jdist.make_mesh(P), dist.make_mesh(P, device="cpu")


def banded(n=256, b=16, bw=24, seed=0):
    r, c, v = jgen.banded_coo(n, bw, seed=seed)
    return jx.from_coo(r, c, v, n, block_size=b)


def random_sparse(n, b, density, seed):
    r, c, v = jgen.random_block_sparse_coo(n, b, density, seed=seed)
    return jx.from_coo(r, c, v, n, block_size=b)


def assert_same_dist(port_m, jax_m, tol=TOL):
    """Per shard: ids and nnz exactly, payloads within `tol` of max|jax|."""
    got, want = dist_to_numpy(port_m), dist_to_numpy(jax_m)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["nnz"], want["nnz"])
    assert rel_to_max(got["data"], want["data"]) <= tol


@pytest.fixture(scope="module")
def ring_cases(meshes):
    """(port inputs, JAX ring result) per case, each JAX call made once."""
    jm, _ = meshes
    out = {}
    a = banded()
    pc, oc = plan_spgemm(a, a)
    ad = jdist.distribute(a, jm)
    out["banded"] = (a, a, dict(pair_cap=pc, out_cap=oc, stage_out_cap=oc),
                     jdist.dist_spgemm(ad, ad, jm, pair_cap=pc, out_cap=oc, stage_out_cap=oc,
                                       backend="xla"))
    a, b = random_sparse(256, 16, 0.15, 1), random_sparse(256, 16, 0.15, 2)
    pc, oc = plan_spgemm(a, b)
    kw = dict(pair_cap=max(pc, 1), out_cap=max(oc, 1), alpha=0.5)
    out["random"] = (a, b, kw, jdist.dist_spgemm(jdist.distribute(a, jm), jdist.distribute(b, jm),
                                                 jm, backend="xla", **kw))
    return out


# --- the mesh and its collectives ---------------------------------------


def test_collectives_match_list_rotation_and_rank_order():
    m = tmesh.make_grid((2, 4), ("host", "chip"), device="cpu")
    xs = [torch.full((3, 2, 2), float(r)) for r in range(8)]
    # ppermute along "chip": index i -> i+1 within each host, a rotation.
    got = tmesh.ppermute(m, xs, "chip", [(i, (i + 1) % 4) for i in range(4)])
    want = [xs[h * 4 + (c - 1) % 4] for h in range(2) for c in range(4)]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert m.traffic.exchanges == [("ppermute", 24, 0)]  # 8 moves of 3 blocks, one device
    # A shard that receives nothing gets zeros, as in JAX.
    got = tmesh.ppermute(m, xs, "host", [(0, 1)])
    assert torch.equal(got[5], xs[1]) and not torch.any(got[1])
    # psum/pmax along "host" and over both axes, in rank order.
    s = [torch.tensor(0.1 * (r + 1)) for r in range(8)]
    by_host = tmesh.psum(m, s, "host")
    for r in range(8):
        assert by_host[r] == s[r % 4] + s[4 + r % 4]
    both = tmesh.psum(m, s, ("host", "chip"))
    acc = s[0]
    for x in s[1:]:
        acc = acc + x
    assert all(torch.equal(v, acc) for v in both)
    flags = [torch.tensor(r == 6) for r in range(8)]
    assert [bool(v) for v in tmesh.pmax(m, flags, "chip")] == [False] * 4 + [True] * 4
    # all_gather along "chip": each shard gets its host's values in chip order.
    gathered = tmesh.all_gather(m, xs, "chip")
    for r in range(8):
        assert [float(t[0, 0, 0]) for t in gathered[r]] == [float(4 * (r // 4) + c)
                                                            for c in range(4)]


def test_mesh_placement_and_no_cpu_fallback(monkeypatch):
    assert tmesh.make_mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.make_mesh(8)
    # Eight shards over four cards: contiguous groups of two.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    devs = tmesh.make_mesh_devices(8)
    assert [d.index for d in devs] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert all(d.type == "cuda" for d in devs)


def test_placement_checked(meshes):
    _, tm = meshes
    ad = dist.distribute(to_port(banded()), tm)
    assert ad.on(tm) is ad
    with pytest.raises(ValueError, match="shards on a mesh"):
        ad.on(dist.make_mesh(4, device="cpu"))


# --- distribute / undistribute -------------------------------------------


def test_distribute_undistribute_bitwise(meshes):
    jm, tm = meshes
    a = banded(seed=3)
    ad, tad = jdist.distribute(a, jm), dist.distribute(to_port(a), tm)
    assert tad.mesh_shape == (P,)
    got, want = dist_to_numpy(tad), dist_to_numpy(ad)
    for k in ("ids", "data", "nnz"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tad.stacked_ids(), np.asarray(ad.ids))
    back, jback = dist.undistribute(tad), jdist.undistribute(ad)
    for k in ("ids", "data"):
        np.testing.assert_array_equal(getattr(back, k).numpy(), np.asarray(getattr(jback, k)))
    assert int(back.nnz) == int(jback.nnz) == int(a.nnz)
    # The JAX package's stacked matrix crosses into the port and back.
    again = dist_block_matrix_from_numpy(**dist_to_numpy(ad), mesh=tm)
    for k, v in dist_to_numpy(again).items():
        np.testing.assert_array_equal(v, want[k])
    assert dist.owner_of_block_row(torch.arange(16), 16, 8).tolist() == [
        int(x) for x in np.asarray(jdist.owner_of_block_row(jax.numpy.arange(16), 16, 8))]


# --- ring SUMMA ------------------------------------------------------------


@pytest.mark.parametrize("case", ["banded", "random"])
def test_dist_spgemm_matches_jax(meshes, ring_cases, case):
    _, tm = meshes
    a, b, kw, (jc, jpairs, jovf) = ring_cases[case]
    c, pairs, ovf = dist.dist_spgemm(dist.distribute(to_port(a), tm),
                                     dist.distribute(to_port(b), tm), tm, backend="xla", **kw)
    assert int(pairs) == int(jpairs) == plan_spgemm(a, b)[0]
    assert bool(ovf) == bool(jovf) is False
    assert_same_dist(c, jc)


def test_dist_spgemm_auto_backend_and_overflow(meshes, ring_cases):
    """The default backend (the fine kernel's plain version at b = 16 with
    row caps, "xla" without) gives the same product; a pair cap below one
    stage's pairs is flagged, as in the JAX package."""
    _, tm = meshes
    a, b, kw, (jc, _, _) = ring_cases["banded"]
    ad = dist.distribute(to_port(a), tm)
    nb = a.nb_rows
    c, pairs, ovf = dist.dist_spgemm(ad, ad, tm, row_caps=(nb, nb), **kw)
    assert not bool(ovf)
    assert_same_dist(c, jc)
    _, _, ovf = dist.dist_spgemm(ad, ad, tm, pair_cap=2, out_cap=kw["out_cap"])
    assert bool(ovf)


def test_frob_truncate_trace_match_jax(meshes):
    jm, tm = meshes
    a = banded(seed=5)
    ad, tad = jdist.distribute(a, jm), dist.distribute(to_port(a), tm)
    np.testing.assert_allclose(float(dist.dist_frob_squared(tad, tm)),
                               float(jdist.dist_frob_squared(ad, jm)), rtol=1e-6)
    np.testing.assert_allclose(float(dist.dist_trace(tad, tm)), float(jdist.dist_trace(ad, jm)),
                               rtol=1e-6, atol=1e-5)
    norms = np.sort(np.sqrt(np.asarray(jx.block_frob_squared(a))[: int(a.nnz)]))
    tau = float(norms[len(norms) // 2] + norms[len(norms) // 2 + 1]) / 2
    assert_same_dist(dist.dist_truncate(tad, tm, tau), jdist.dist_truncate(ad, jm, tau), tol=0)
    assert int(dist.undistribute(dist.dist_truncate(tad, tm, 1e9)).nnz) == 0


def test_dist_sp2_step_matches_jax(meshes):
    jm, tm = meshes
    n, b = 256, 16
    a = banded(n, b, bw=20, seed=9)
    x = jx.scale(a, 1.0 / float(np.sqrt(float(jx.frob_squared(a)))))
    x = jx.add(x, jx.eye(n, b), beta=0.5, cap=x.cap + n // b)
    pc, oc = plan_spgemm(x, x)
    kw = dict(tau=1e-7, pair_cap=2 * pc, out_cap=2 * oc, stage_out_cap=2 * oc,
              target_trace=n / 2)
    xd = jdist.distribute(jx.repack(x, 2 * oc), jm)
    want, wst = jdist.dist_sp2_step(xd, jm, backend="xla", **kw)
    got, st = dist.dist_sp2_step(dist_block_matrix_from_numpy(**dist_to_numpy(xd), mesh=tm),
                                 tm, backend="xla", **kw)
    assert int(st["n_block_pairs"]) == int(wst["n_block_pairs"]) == pc
    assert bool(st["overflow"]) == bool(wst["overflow"]) is False
    np.testing.assert_allclose(float(st["trace"]), float(wst["trace"]), rtol=1e-6)
    assert_same_dist(got, want)
    # A per-shard cap below the kept blocks is flagged.
    _, st = dist.dist_sp2_step(dist_block_matrix_from_numpy(**dist_to_numpy(xd), mesh=tm), tm,
                               backend="xla", cap=1, **kw)
    assert bool(st["overflow"])


def test_dryrun_multichip_on_cpu(capsys):
    from hierarchical_block_sparse_lib_tpu_torch.entry import dryrun_multichip

    lines = dryrun_multichip(8, device="cpu")
    assert len(lines) == 8 and all("OK" in line for line in lines)
    assert "=== all 8 stages OK ===" in capsys.readouterr().out


def test_distributed_matrix_checks():
    m = dataclasses.replace
    tm = dist.make_mesh(2, device="cpu")
    a = dist.distribute(to_port(banded(64, 16, 8)), tm)
    with pytest.raises(ValueError, match="capacities"):
        tmesh.DistBlockMatrix((a.shards[0], m(a.shards[1], ids=a.shards[1].ids[:1])), (2,))
    with pytest.raises(ValueError, match="shards for a mesh"):
        tmesh.DistBlockMatrix(a.shards, (3,))
