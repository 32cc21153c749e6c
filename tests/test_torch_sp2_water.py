"""SP2 purification of the water-cluster deployment at leaf 32, cut to 64
molecules (n = 832, 26 leaf blocks a side): the benchmark's generator
(`benchmark/reference/sp2.py`), `PurifyEngine` on the port's CPU paths
against the plain float64 reference within the cell's limits, the
planned scan against the unplanned one, the port's `purify_scan`
against the JAX package's, and the reference's pair count against the
program's.  The deployment's tau; 32 steps, the configuration's rule
(float64 idempotency below 1e-5, plus 2) at this size."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from benchmark import harness
from benchmark.reference import common
from benchmark.reference import sp2 as ref_sp2
from benchmark.systems import sp2 as sys_sp2
from hierarchical_block_sparse_lib_tpu.models import purification as jpur
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import resolve_backend

MOLECULES, STEPS, SEED = 64, 32, 2**31 + 2201
# Steps the port and the JAX package are compared over: their f32 traces
# stay far from N_occ, so both take the same branches.
JAX_STEPS = 24


def small_cell(steps: int = STEPS) -> harness.Cell:
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(spec, "b3_sp2.planned")
    cell.cfg["molecules"] = MOLECULES
    cell.cfg["assumed"].update(n_occ=5 * MOLECULES, n_steps=steps)
    return cell


@pytest.fixture(scope="module")
def member():
    return ref_sp2.make_inputs(small_cell().cfg, 1, SEED, "cpu")[0]


@pytest.fixture(scope="module")
def x0(member):
    """X0 = (rho I - F) / (2 rho) as the benchmark's session makes it."""
    f = sys_sp2.matrix(member.ids, member.data, member.n, member.b)
    rho = tx.gershgorin_bound(f)
    return tx.add(tx.eye(member.n, member.b, device="cpu"), f, alpha=0.5, beta=-0.5 / rho)


def test_generator_is_a_gapped_symmetric_fock_matrix(member):
    cfg = small_cell().cfg
    nb = member.n // member.b
    assert member.n == 13 * MOLECULES and member.n % member.b == 0
    assert np.all(np.diff(member.ids) > 0) and member.ids[-1] < nb * nb
    f = common.dense(member.ids, member.data, nb, torch.float64)
    assert torch.equal(f, f.T)
    ev = torch.linalg.eigvalsh(f)
    n_occ = cfg["assumed"]["n_occ"]
    assert float(ev[n_occ] - ev[n_occ - 1]) > 0.1
    assert float(ev[n_occ - 1]) < 0 < float(ev[n_occ])
    # The same seed gives the same matrix; another seed another one.
    again = ref_sp2.fock(cfg, SEED)
    np.testing.assert_array_equal(again[0], member.ids)
    assert not np.array_equal(ref_sp2.fock(cfg, SEED + 1)[1], again[1])


def test_cluster_is_compact_and_in_morton_order():
    pos = ref_sp2.cluster(small_cell().cfg, np.random.default_rng(3))
    assert pos.shape == (MOLECULES, 3)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1) + 1e3 * np.eye(MOLECULES)
    # Liquid density: nearest neighbours one lattice spacing apart.
    spacing = 0.0334 ** (-1 / 3)
    assert np.all(np.abs(d.min(1) - spacing) < 0.25 * spacing)
    # Morton order keeps molecules near in index near in space: a step to
    # the next molecule is under two spacings on average.
    assert np.linalg.norm(np.diff(pos, axis=0), axis=1).mean() < 2 * spacing


def test_engine_matches_the_reference_within_the_cells_limits(member):
    cell = small_cell()
    s = sys_sp2.Session(cell.cfg, cell.traffic, [member])
    out = s.call(0)
    assert not any(bool(f.any()) for f in s.flags(out))
    s.call(1)
    got = s.export(s.call(2))
    nums = ref_sp2.compare(got, ref_sp2.reference(cell.cfg, member))
    assert nums["replans"] == 0
    for k, v in nums.items():
        assert v <= cell.cfg["limits"][k], (k, v)
    assert nums["d_err"] < 1e-5


def test_planned_scan_equals_unplanned_bit_for_bit(x0):
    cfg = small_cell().cfg["assumed"]
    eng = tx.PurifyEngine(STEPS, cfg["tau"], target_trace=cfg["n_occ"])
    xp, sp = eng.run(x0)
    assert eng.n_replans == 1 and not bool(sp.plan_mismatch.any())
    assert resolve_backend(32, torch.float32, 26, eng.prof.pair_cap,
                           row_caps=eng.prof.row_caps) == "fine"
    xu, su = tx.purify_scan(x0, STEPS, cfg["tau"], target_trace=cfg["n_occ"],
                            **eng.prof.kwargs())
    assert torch.equal(xp.ids, xu.ids) and torch.equal(xp.nnz, xu.nnz)
    assert torch.equal(xp.data, xu.data)
    for f in dataclasses.fields(su):
        assert torch.equal(getattr(sp, f.name), getattr(su, f.name)), f.name


def _margins(x, steps, tau, n_occ, prof):
    """Each step's least |norm / tau - 1| over the pre-truncation blocks of
    the port's unplanned trajectory: a keep/drop decision closer than
    this to tau may flip with the summation order."""
    x = tx.repack(x, prof.cap)
    margins = []
    for _ in range(steps):
        s = (tx.trace(x) > n_occ).float()
        y, _ = tx.spgemm(x, x, prof.pair_cap, prof.out_cap, row_caps=prof.row_caps,
                         accum=x, alpha=2 * s - 1, beta=2 - 2 * s)
        norms = tx.block_frob_squared(y).sqrt()[y.valid_mask()]
        margins.append(float(torch.min(torch.abs(norms / tau - 1))))
        x, _ = tx.truncate(y, tau, cap=prof.cap)
    return margins


def test_purify_scan_matches_jax_at_leaf_32(x0):
    cfg = small_cell().cfg["assumed"]
    tau, n_occ = cfg["tau"], float(cfg["n_occ"])
    prof = tx.profile_purify(x0, JAX_STEPS, tau, target_trace=n_occ)
    assert min(_margins(x0, JAX_STEPS, tau, n_occ, prof)) > 1e-3
    jm = jx.BlockMatrix(ids=jnp.asarray(x0.ids.numpy()), data=jnp.asarray(x0.data.numpy()),
                        nnz=jnp.asarray(int(x0.nnz), jnp.int32), n_rows=x0.n_rows,
                        n_cols=x0.n_cols, block_size=32)
    kw = dict(target_trace=n_occ, **prof.kwargs())
    ty, ts = tx.purify_scan(x0, JAX_STEPS, tau, **kw)
    jy, js = jpur.purify_scan(jm, JAX_STEPS, tau, backend="xla", **kw)
    np.testing.assert_array_equal(ty.ids.numpy(), np.asarray(jy.ids))
    assert int(ty.nnz) == int(jy.nnz)
    scale = float(np.abs(np.asarray(jy.data)).max())
    np.testing.assert_allclose(ty.data.numpy(), np.asarray(jy.data), rtol=1e-5, atol=1e-5 * scale)
    for f in dataclasses.fields(ts):
        g, w = getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name))
        if f.name == "trace":
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_reference_work_counts_the_programs_pairs(member, x0):
    """Where no block norm lies within 0.1% of tau, the reference (float64)
    and the program (float32) keep the same blocks every step, and so
    count the same pairs."""
    cell = small_cell(JAX_STEPS)
    cfg = cell.cfg["assumed"]
    tau, n_occ = cfg["tau"], float(cfg["n_occ"])
    eng = tx.PurifyEngine(JAX_STEPS, tau, target_trace=n_occ)
    _, stats = eng.run(x0)
    assert min(_margins(x0, JAX_STEPS, tau, n_occ, eng.prof)) > 1e-3
    ref = ref_sp2.reference(cell.cfg, member)
    w = ref_sp2.work(cell.cfg, member, ref)
    assert ref["pairs"] == stats.n_block_pairs.tolist()
    assert ref["kept"] == stats.nnz_blocks.tolist()
    assert w["pairs"] == int(stats.n_block_pairs.sum())
    assert w["flops"] == 2 * 32**3 * w["pairs"]
    # Every step reads its input once and writes its output once.
    held = int(x0.nnz) + 2 * sum(ref["kept"][:-1]) + ref["kept"][-1]
    assert w["bytes"] == held * 32 * 32 * 4
