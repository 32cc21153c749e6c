"""The Loewdin factor of the water-cluster deployment at leaf 32, cut to
its 32 central molecules (n = 416, 13 leaf blocks a side, S dense at this size): the
benchmark's overlap generator (`benchmark/reference/invsqrt.py`),
`InvSqrtEngine` on the port's CPU paths against the plain float64
reference within the cell's limits, the planned iteration against the
unplanned one, `profile_inv_sqrt`'s capacities, the reference's pair
count against the program's, the engine's spans and replan, and the
port against the JAX package's `inv_sqrt_newton_schulz` with `cap` left
at its default.  The deployment's tau; 11 steps, past the float64
reference's best step at this size."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu.models as jmodels
import hierarchical_block_sparse_lib_tpu_torch as tx
from benchmark import harness
from benchmark.reference import common
from benchmark.reference import invsqrt as ref_ns
from benchmark.reference import sp2 as ref_sp2
from benchmark.systems import invsqrt as sys_ns
from benchmark.systems.chain import matrix
from hierarchical_block_sparse_lib_tpu_torch.kernels.pallas_gemm_fine import _bucket
from hierarchical_block_sparse_lib_tpu_torch.models import inv_sqrt_newton_schulz
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import resolve_backend

MOLECULES, STEPS, SEED = 32, 11, 2**31 + 2601
# Steps of the capacity profile's checks, and those the port and the JAX
# package are compared over.
PROFILE_STEPS, JAX_STEPS = 6, 4


def small_cell() -> harness.Cell:
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(spec, "b3_invsqrt.planned")
    cell.cfg["molecules"] = MOLECULES
    cell.cfg["assumed"]["n_steps"] = STEPS
    return cell


@pytest.fixture(scope="module")
def member():
    torch.set_num_threads(1)
    return ref_ns.make_inputs(small_cell().cfg, 1, SEED, "cpu")[0]


@pytest.fixture(scope="module")
def s(member):
    return matrix(member.ids, member.data, member.n, member.b)


@pytest.fixture(scope="module")
def theta(s):
    return tx.gershgorin_bound(s)


@pytest.fixture(scope="module")
def prof(s, theta):
    return tx.profile_inv_sqrt(s, theta, PROFILE_STEPS, small_cell().cfg["assumed"]["tau"])


@pytest.fixture(scope="module")
def session(member):
    """The benchmark's session and its first call (the engine's plan)."""
    cell = small_cell()
    sess = sys_ns.Session(cell.cfg, cell.traffic, [member])
    return sess, sess.call(0)


def test_generator_gives_a_positive_definite_overlap_in_morton_order(member):
    cfg = small_cell().cfg
    nb = member.n // member.b
    assert member.n == 13 * MOLECULES and nb * member.b == member.n
    assert np.all(np.diff(member.ids) > 0) and member.ids[-1] < nb * nb
    d = common.dense(member.ids, member.data, nb, torch.float64)
    assert torch.equal(d, d.T)
    assert float((d.diagonal() - 1).abs().max()) < 1e-6  # f32 of S_ii = 1
    ev = torch.linalg.eigvalsh(d)
    assert 0.01 < float(ev[0]) and float(ev[-1]) < 6.0
    # The same seed gives the same matrix from a float64 S with S_ii = 1.
    s64 = ref_ns.overlap(cfg, SEED, "cpu")
    assert torch.equal(s64, s64.T) and float((s64.diagonal() - 1).abs().max()) < 1e-15
    assert torch.equal(common.dense(member.ids, member.data, nb, torch.float32),
                       s64.to(torch.float32))
    # Oxygens at the sites nearest the centre of the SP2 cell's cluster
    # for the same seed and member, in its Morton order; the hydrogens at
    # r(OH) with the HOH angle.
    atoms = ref_ns.geometry(cfg, SEED) / ref_ns.BOHR_PER_A
    sp2_cfg = harness.load_json(os.path.join(
        harness.ROOT, "benchmark/configs/sp2_water2048_321g_leaf32.json"))
    assert cfg["assumed"]["cluster_molecules"] == sp2_cfg["molecules"]
    sites = ref_sp2.cluster(sp2_cfg, ref_sp2.gen.host_rng(SEED, 0, 0))
    r = np.linalg.norm(sites, axis=1)
    near = np.flatnonzero(r <= np.sort(r)[MOLECULES - 1])
    assert near.size == MOLECULES
    np.testing.assert_allclose(atoms[:, 0], sites[near], rtol=0, atol=1e-12)
    oh = np.linalg.norm(atoms[:, 1:] - atoms[:, :1], axis=-1)
    np.testing.assert_allclose(oh, 0.9572, rtol=1e-12)
    u, v = atoms[:, 1] - atoms[:, 0], atoms[:, 2] - atoms[:, 0]
    cos = np.sum(u * v, -1) / (oh[:, 0] * oh[:, 1])
    np.testing.assert_allclose(np.rad2deg(np.arccos(cos)), 104.52, rtol=1e-10)


def test_overlap_integrals_in_closed_form():
    """One s and p function pair against the formulas: two normalised s
    primitives of exponents a, b at distance r overlap by
    (2 sqrt(a b) / (a + b))^(3/2) exp(-a b r^2 / (a + b)), and p_x on A
    with s on B by (P_x - A_x) times that and the p normalisation."""
    a, b, r = 0.37, 0.18, 2.5
    cfg = dict(assumed=dict(basis_3_21g=dict(
        O=[dict(shell="s", exponents=[a], s=[1.0]), dict(shell="sp", exponents=[a], s=[1.0],
                                                          p=[1.0]),
           dict(shell="sp", exponents=[a], s=[1.0], p=[1.0])],
        H=[dict(shell="s", exponents=[b], s=[1.0]), dict(shell="s", exponents=[b], s=[1.0])])))
    prims = ref_ns.primitives(cfg)
    atoms_i = torch.zeros((1, 3, 3), dtype=torch.float64)
    atoms_j = torch.full((1, 3, 3), 50.0, dtype=torch.float64)
    atoms_j[0, 1] = torch.tensor([r, 0.0, 0.0])
    blk = ref_ns.pair_blocks(prims, atoms_i, atoms_j)[0]
    ss = (2 * np.sqrt(a * b) / (a + b)) ** 1.5 * np.exp(-a * b * r * r / (a + b))
    assert float(blk[0, 9]) == pytest.approx(ss, rel=1e-13)  # O s with H1 s
    px = 2 * np.sqrt(a) * (b * r / (a + b)) * ss  # <p_x|s>, p normalised
    assert float(blk[2, 9]) == pytest.approx(px, rel=1e-13)
    assert abs(float(blk[3, 9])) < 1e-16 and abs(float(blk[4, 9])) < 1e-16
    own = ref_ns.pair_blocks(prims, atoms_i, atoms_i)[0]
    assert float(own[2, 2]) == pytest.approx(1.0, rel=1e-13)  # <p_x|p_x> normalised


def test_reference_falls_to_a_best_step_and_then_diverges(member):
    """The float64 reference's ||Z_k S Z_k - I||_F / sqrt(n) falls to a
    least value and grows every step after it: this Newton-Schulz form
    amplifies errors that do not commute with S (kappa(S) > 9), which is
    why the cell runs to its best step and no further."""
    orth = ref_ns.reference(small_cell().cfg, member, steps=14, orth_each_step=True)["orth"]
    assert len(orth) == 15 and orth[0] > 0.5
    best = int(np.argmin(orth))
    assert 6 < best < 14 and orth[best] < 1e-5
    assert all(b > a for a, b in zip(orth[best:], orth[best + 1:]))


def test_engine_matches_the_reference_within_the_cells_limits(member, session):
    cell = small_cell()
    sess, out = session
    assert not any(bool(f.any()) for f in sess.flags(out))
    got = sess.export(sess.call(1))
    nums = ref_ns.compare(got, ref_ns.reference(cell.cfg, member))
    assert nums["replans"] == 0
    for k, v in nums.items():
        assert v <= cell.cfg["limits"][k], (k, v)
    assert nums["z_err"] < 1e-4 and nums["pairs_rel_diff"] == 0.0


def test_planned_iteration_equals_unplanned_bit_for_bit(s, session):
    tau = small_cell().cfg["assumed"]["tau"]
    zp, tp, op, eng = session[1]
    assert eng.n_replans == 1 and not bool(op)
    assert resolve_backend(32, torch.float32, s.nb_cols, eng.prof.pair_cap,
                           row_caps=eng.prof.row_caps) == "fine"
    zu, tu, ou = inv_sqrt_newton_schulz(s, tx.gershgorin_bound(s), STEPS, tau,
                                        **eng.prof.kwargs())
    assert not bool(ou) and int(tu) == int(tp)
    assert torch.equal(zp.ids, zu.ids) and torch.equal(zp.nnz, zu.nnz)
    assert torch.equal(zp.data, zu.data)
    # Z lives at the profile's iterate capacity, not at out_cap.
    assert zp.cap == eng.prof.cap


def test_profile_caps_are_exact(s, theta, prof):
    tau = small_cell().cfg["assumed"]["tau"]
    kw = prof.kwargs()

    def overflows(**caps) -> bool:
        return bool(inv_sqrt_newton_schulz(s, theta, PROFILE_STEPS, tau, **dict(kw, **caps))[2])

    assert not overflows()
    for key in ("pair_cap", "out_cap", "cap"):
        assert overflows(**{key: kw[key] - 1}), key
    # Each per-step entry holds the three products' needs; the caps are
    # their maxima, and Z_0's identity is held too.
    assert prof.pair_cap == max(max(p) for p in prof.per_step_pairs)
    assert prof.out_cap == max(max(o) for o in prof.per_step_out)
    assert prof.cap == max([s.nb_rows] + list(prof.per_step_kept))
    # S is dense at this size: every B row and output row holds the grid.
    assert prof.row_caps == (s.nb_cols, s.nb_cols)
    for i, need in enumerate(prof.row_caps):
        # The kernels round a row cap up to a multiple of 8: the largest
        # cap below the need in those units overflows.
        under = list(prof.row_caps)
        under[i] = _bucket(need) - 8
        assert _bucket(under[i]) < need
        assert overflows(row_caps=tuple(under)), i


def test_reference_counts_the_programs_pairs(member, s, theta, prof):
    cfg = small_cell().cfg
    ref = ref_ns.reference(cfg, member, steps=PROFILE_STEPS)
    assert [tuple(p) for p in ref["pairs"]] == [tuple(p) for p in prof.per_step_pairs]
    assert ref["kept"] == list(prof.per_step_kept)
    _, total, _ = inv_sqrt_newton_schulz(s, theta, PROFILE_STEPS, cfg["assumed"]["tau"],
                                         **prof.kwargs())
    assert int(total) == ref_ns.work(cfg, member, ref)["pairs"]


def _span_tree(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name() in ("hbsm.inv_sqrt", "hbsm.replan", "hbsm.engine_check")),
                    key=lambda r: (r[0], -r[1]))
    roots, stack = [], []
    for s0, s1, name in ranges:
        while stack and stack[-1][0] <= s0:
            stack.pop()
        node = (name, [])
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((s1, node))
    return roots


def test_engine_spans_and_replan_on_drift(s):
    """`run` is one ``hbsm.inv_sqrt``: the replan (first call) or the
    structure check, the iteration's own ``hbsm.inv_sqrt``, then the flag
    check.  S with another structure replans before it runs."""
    tau = small_cell().cfg["assumed"]["tau"]
    eng = tx.InvSqrtEngine(2, tau)
    [(name, kids)] = _span_tree(eng.run, s)
    assert name == "hbsm.inv_sqrt"
    assert [k[0] for k in kids] == ["hbsm.replan", "hbsm.inv_sqrt", "hbsm.engine_check"]
    assert _span_tree(eng.run, s) == [("hbsm.inv_sqrt", [
        ("hbsm.engine_check", []), ("hbsm.inv_sqrt", []), ("hbsm.engine_check", [])])]
    assert eng.n_replans == 1
    # Drop S's weakest block pair: S stays positive definite, its ids differ.
    norms = torch.linalg.matrix_norm(s.data[: int(s.nnz)])
    k = int(torch.argmin(norms))
    blk = int(s.ids[k])
    nb = s.nb_cols
    mate = (blk % nb) * nb + blk // nb
    keep = (s.ids != blk) & (s.ids != mate)
    drift = matrix(s.ids[keep].numpy().astype(np.int64), s.data[keep], s.n_rows, s.block_size)
    _, _, ovf = eng.run(drift)
    assert eng.n_replans == 2 and not bool(ovf)
    assert torch.equal(eng.plans.p_zy[0].b_ids, drift.ids)


def test_port_equals_jax_with_cap_at_its_default(s, theta, prof):
    """With `cap` left out, Z stays at out_cap, as in the JAX package."""
    tau = small_cell().cfg["assumed"]["tau"]
    th = float(theta)
    kw = dict(pair_cap=prof.pair_cap, out_cap=prof.out_cap)
    tz, tt, to = inv_sqrt_newton_schulz(s, th, JAX_STEPS, tau, **kw)
    js = jx.BlockMatrix(ids=jnp.asarray(s.ids.numpy()), data=jnp.asarray(s.data.numpy()),
                        nnz=jnp.asarray(int(s.nnz), jnp.int32), n_rows=s.n_rows,
                        n_cols=s.n_cols, block_size=32)
    jz, jt, jo = jmodels.inv_sqrt_newton_schulz(js, th, JAX_STEPS, tau, **kw)
    assert tz.cap == prof.out_cap
    np.testing.assert_array_equal(tz.ids.numpy(), np.asarray(jz.ids))
    assert int(tz.nnz) == int(jz.nnz) and int(tt) == int(jt)
    assert bool(to) == bool(jo) is False
    scale = float(np.abs(np.asarray(jz.data)).max())
    np.testing.assert_allclose(tz.data.numpy(), np.asarray(jz.data), rtol=1e-5, atol=1e-5 * scale)
