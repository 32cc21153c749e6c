"""The port's ablation scripts `profile_b3`, `profile_scan`,
`bench_symmetric` and `profile_routed_1dev`
(`hierarchical_block_sparse_lib_tpu_torch/scripts/`) on the CPU at cut
sizes, against the JAX package on the same numpy-built inputs: each
`main`'s last stdout line (its counters, caps, plans and checks), and the
structures and results behind it, ids and counters exactly, payloads
within 1e-5.  Off the card a script measures no time.  `bench_symmetric.py`
of the JAX repo runs at import, so its input recipe is mirrored here with
the JAX package's ops."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

import bench as jbench
import hierarchical_block_sparse_lib_tpu as jx
from hierarchical_block_sparse_lib_tpu.models.purification import (
    plan_purify as jplan_purify,
    profile_purify as jprofile_purify,
    purify_scan as jpurify_scan,
)
from hierarchical_block_sparse_lib_tpu.ops.norms import trace as jtrace
from hierarchical_block_sparse_lib_tpu.ops.repack import repack as jrepack
from hierarchical_block_sparse_lib_tpu.ops.spgemm import (
    make_plan as jmake_plan,
    plan_spgemm_ex as jplan_spgemm_ex,
    spgemm as jspgemm,
)
from hierarchical_block_sparse_lib_tpu.ops.truncate import truncate as jtruncate
from hierarchical_block_sparse_lib_tpu.parallel import dist as jdist, route as jroute
import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.ops.repack import repack
from hierarchical_block_sparse_lib_tpu_torch.scripts import (
    bench_symmetric,
    profile_b3,
    profile_routed_1dev,
    profile_scan,
)

from torch_port_helpers import (
    assert_same_matrix,
    import_jax_script,
    rel_to_max,
    torch_threads,
)

DEV = "cpu"
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def assert_untimed(rec):
    """Off the card: every part measured no time, every difference None."""
    assert rec["device"].startswith("cpu") and rec["peak_gib"] is None
    for part in rec["parts"].values():
        assert part["ms"] is None and part["device_ms"] is None and part["kernels"] == {}
    assert all(v is None for v in rec["derived"].values())
    assert all(rec["checks"].values())


def jax_profile_record(prof) -> dict:
    return dict(per_step_pairs=list(prof.per_step_pairs), per_step_out=list(prof.per_step_out),
                per_step_kept=list(prof.per_step_kept), pair_cap=prof.pair_cap,
                out_cap=prof.out_cap, cap=prof.cap, row_caps=list(prof.row_caps))


# -- profile_b3 ------------------------------------------------------------

def jax_b3_input(n, bw):
    """scripts/profile_b3.py:51-54 with the JAX package's ops."""
    a = jbench.banded_block_matrix(n, bw, 128)
    a = jx.add(a, jx.transpose(a), alpha=0.5, beta=0.5)
    a = jx.scale(a, 1.0 / float(np.sqrt(float(jx.frob_squared(a)))))
    return jx.add(a, jx.eye(n, 128), beta=0.5, cap=a.cap + n // 128)


def test_profile_b3_matches_jax(capsys):
    n, bw, steps, tau = 768, 48, 5, 1e-6
    assert profile_b3.main([], device=DEV, n=n, bw=bw, steps=steps, tau=tau) == 0
    rec = last_line(capsys)
    assert_untimed(rec)
    assert set(rec["parts"]) == {"scan", "sp2_step", "spgemm+accum", "spgemm plain",
                                 "spgemm plan=", "truncate", "trace"}
    ja = jax_b3_input(n, bw)
    jprof = jprofile_purify(ja, steps, tau=tau, target_trace=n / 2, backend="xla")
    want = jax_profile_record(jprof)
    assert {k: rec["counters"][k] for k in want} == want
    assert rec["counters"]["blocks"] == int(ja.nnz)
    A, prof, X2 = profile_b3.setup(n, bw, steps, tau, DEV)
    jx2, _ = jpurify_scan(ja, 2, tau, target_trace=n / 2, backend="xla", **jprof.kwargs())
    assert_same_matrix(A, ja)
    assert_same_matrix(X2, jx2)
    assert rec["counters"]["iterate_nnz"] == int(jx2.nnz)


def test_profile_b3_expects_the_configured_profile():
    """The full-size check holds the JAX package's B3 profile (PERF.md §4),
    the numbers chip_smoke.py's phase 7 holds too."""
    import chip_smoke

    want = profile_b3.EXPECTED[(4096, 256, 5, 1e-6)]
    p = chip_smoke.B3_PROFILE
    assert want == dict(per_step_pairs=list(p["per_step_pairs"]), pair_cap=p["pair_cap"],
                        out_cap=p["out_cap"], cap=p["cap"], row_caps=list(p["row_caps"]))


# -- profile_scan ------------------------------------------------------------

SCAN = dict(n=1024, density=0.2, seed=7, n_steps=3, tau=1e-2)


@pytest.fixture(scope="module")
def scan_case():
    """The port's and the JAX package's planned trajectory at a cut size
    whose truncation drops blocks, so that the variants that skip it leave
    the plan."""
    c = SCAN
    jps = import_jax_script("profile_scan")
    jX = jps.build_input(c["n"], c["density"], c["seed"])
    X = profile_scan.build_input(c["n"], c["density"], c["seed"], DEV)
    nocc = X.n_rows // 4
    jprof = jprofile_purify(jX, c["n_steps"], tau=c["tau"], target_trace=nocc, backend="xla")
    jplans = jplan_purify(jX, c["n_steps"], c["tau"], jprof, target_trace=nocc, backend="xla")
    prof = hbsm.profile_purify(X, c["n_steps"], c["tau"], target_trace=nocc)
    plans = hbsm.plan_purify(X, c["n_steps"], c["tau"], prof, target_trace=nocc)
    return dict(jps=jps, jX=jX, X=X, nocc=nocc, jprof=jprof, jplans=jplans, prof=prof,
                plans=plans)


def jax_variant_flags(variant, prof, plans, nocc, x, n_steps, tau):
    """plan_mismatch per step of `make_variant`'s step
    (scripts/profile_scan.py:68-88), run eagerly with the JAX package's
    public ops: (final iterate, flags)."""
    pc, oc, cap, rc = prof.pair_cap, prof.out_cap, prof.cap, prof.row_caps
    flags = []
    for k in range(n_steps):
        pl = type(plans.plans)(**{f.name: getattr(plans.plans, f.name)[k]
                                  for f in dataclasses.fields(plans.plans)
                                  if getattr(plans.plans, f.name) is not None})
        if variant in ("full", "notrunc"):
            s = (jtrace(x) > nocc).astype(x.dtype)
            alpha, beta = 2.0 * s - 1.0, 2.0 - 2.0 * s
        else:
            alpha, beta = -1.0, 2.0
        y, info = jspgemm(x, x, pair_cap=pc, out_cap=oc, row_caps=rc, accum=x, alpha=alpha,
                          beta=beta, plan=pl, backend="xla")
        if variant in ("full", "notrace"):
            y, _ = jtruncate(y, tau, cap=cap)
        else:
            y = dataclasses.replace(x, ids=y.ids[:cap], data=y.data[:cap],
                                    nnz=jnp.minimum(y.nnz, cap))
        x = y
        flags.append(bool(info.plan_mismatch))
    return x, flags


@pytest.mark.parametrize("variant", profile_scan.VARIANTS)
def test_profile_scan_variant_matches_jax(variant, scan_case, monkeypatch):
    c, s = SCAN, scan_case
    assert s["prof"].per_step_pairs == s["jprof"].per_step_pairs
    x_cap = repack(s["X"], s["prof"].cap)
    jx_cap = jrepack(s["jX"], s["jprof"].cap)
    got, flags = profile_scan.make_variant(variant, s["prof"], s["plans"], s["nocc"], x_cap,
                                           c["n_steps"], c["tau"])()
    jfinal, jflags = jax_variant_flags(variant, s["jprof"], s["jplans"], s["nocc"], jx_cap,
                                       c["n_steps"], c["tau"])
    assert flags.tolist() == jflags
    if any(jflags):  # a stale plan's output is undefined in either package
        return
    assert_same_matrix(got, jfinal)
    # The JAX script's own variant (its module constants set to the cut
    # run's): the same final payload.
    monkeypatch.setattr(s["jps"], "N_STEPS", c["n_steps"])
    monkeypatch.setattr(s["jps"], "TAU", c["tau"])
    want = s["jps"].make_variant(variant, s["jprof"], s["jplans"], s["nocc"], jx_cap)(jx_cap.data)
    assert rel_to_max(got.data.numpy(), np.asarray(want)) <= TOL


def test_profile_scan_flags_by_design(scan_case):
    """At the cut size the variants that skip truncation leave the planned
    trajectory and say so; `full` and `notrace` keep to it."""
    c, s = SCAN, scan_case
    x_cap = repack(s["X"], s["prof"].cap)
    flags = {v: profile_scan.make_variant(v, s["prof"], s["plans"], s["nocc"], x_cap,
                                          c["n_steps"], c["tau"])()[1].tolist()
             for v in profile_scan.VARIANTS}
    assert not any(flags["full"]) and not any(flags["notrace"])
    assert any(flags["bare"]) and any(flags["notrunc"])


def test_profile_scan_main(capsys, scan_case):
    assert profile_scan.main([], device=DEV, **SCAN) == 0
    rec = last_line(capsys)
    assert_untimed(rec)
    assert rec["counters"]["per_step_pairs"] == list(scan_case["jprof"].per_step_pairs)
    assert rec["counters"]["cap"] == scan_case["jprof"].cap
    assert rec["counters"]["out_cap"] == scan_case["jprof"].out_cap
    assert set(rec["counters"]["plan_mismatch"]) == set(profile_scan.VARIANTS)
    assert set(rec["parts"]) == {*profile_scan.VARIANTS, "purify_scan", "eager",
                                 "compact/scatter", "compact/gather"}
    assert rec["compact_gb_per_s"] == {"scatter": None, "gather": None}


def test_profile_scan_compaction_matches_jax():
    """Both compactions against the JAX script's scatter formulation
    (scripts/profile_scan.py:178-183) on the same input: equal."""
    oc, cap, b = 24, 16, 128
    comp = profile_scan.compaction(oc, cap, b, DEV)
    d = jnp.asarray(np.random.default_rng(0).standard_normal((oc, b, b)), jnp.float32)
    keep = jnp.asarray(np.random.default_rng(1).random(oc) < 0.7)
    slot = jnp.where(keep, jnp.cumsum(keep) - 1, cap).astype(jnp.int32)
    want = np.asarray(jnp.zeros((cap, b, b), d.dtype).at[slot].set(d, mode="drop"))
    np.testing.assert_array_equal(comp["scatter"]().numpy(), want)
    np.testing.assert_array_equal(comp["gather"]().numpy(), want)


def test_profile_scan_failing_variant_ends_the_run(monkeypatch, capsys):
    """No swallowed failure: a variant that raises ends main with it (the
    module run exits non-zero) and prints no last line."""
    make = profile_scan.make_variant

    def failing(variant, *args):
        if variant == "notrunc":
            def run():
                raise RuntimeError("notrunc failed")
            return run
        return make(variant, *args)

    monkeypatch.setattr(profile_scan, "make_variant", failing)
    with pytest.raises(RuntimeError, match="notrunc failed"):
        profile_scan.main([], device=DEV, **SCAN)
    assert "{" not in capsys.readouterr().out


# -- bench_symmetric ------------------------------------------------------------

SYM = dict(n_b3=768, bw=48, n_big=768)


def jax_b3_scale_input(n, bw):
    """scripts/bench_symmetric.py:51-56 with the JAX package's ops."""
    d = np.asarray(jx.to_dense(jbench.banded_block_matrix(n, bw, 128)))
    ds = ((d + d.T) / 2).astype(np.float32)
    ds = ds / max(1.0, 1.05 * np.abs(ds).sum(1).max())
    return jx.from_dense(0.55 * np.eye(n, dtype=np.float32) - ds, block_size=128)


@pytest.fixture(scope="module")
def sym_run():
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert bench_symmetric.main([], device=DEV, **SYM) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["B3-scale", "big-sym"])
def test_bench_symmetric_matches_jax(name, sym_run):
    assert_untimed(sym_run)
    tau = 1e-7
    if name == "B3-scale":
        jX, X, steps = (jax_b3_scale_input(SYM["n_b3"], SYM["bw"]),
                        bench_symmetric.b3_scale_input(SYM["n_b3"], SYM["bw"], DEV), 5)
    else:
        jX = import_jax_script("profile_scan").build_input(SYM["n_big"])
        X, steps = profile_scan.build_input(SYM["n_big"], device=DEV), 3
    assert_same_matrix(X, jX, rtol=0, atol=0)
    nocc = jX.n_rows // 4
    jprof = jprofile_purify(jX, steps, tau=tau, target_trace=nocc, backend="xla")
    jps = jplan_purify(jX, steps, tau, jprof, target_trace=nocc, symmetric=True, backend="xla")
    jy, jst = jpurify_scan(jX, steps, tau, plans=jps, symmetric=True, target_trace=nocc,
                           backend="xla", **jprof.kwargs())
    rec = sym_run["counters"][name]
    assert rec["generic"] == rec["profile_pairs"] == list(jprof.per_step_pairs)
    assert rec["symmetric"] == np.asarray(jst.n_block_pairs).tolist()
    assert rec["blocks"] == int(jX.nnz) and rec["steps"] == steps
    prof = hbsm.profile_purify(X, steps, tau, target_trace=nocc)
    plans = hbsm.plan_purify(X, steps, tau, prof, target_trace=nocc, symmetric=True)
    y, _ = hbsm.purify_scan(X, steps, tau, plans=plans, symmetric=True, target_trace=nocc,
                            **prof.kwargs())
    assert_same_matrix(y, jy)


# -- profile_routed_1dev ------------------------------------------------------------

ROUTED = dict(n=2048, density=0.2)


def test_profile_routed_1dev_matches_jax(capsys):
    n, dens = ROUTED["n"], ROUTED["density"]
    assert profile_routed_1dev.main([], device=DEV, n=n, density=dens) == 0
    rec = last_line(capsys)
    assert_untimed(rec)
    ja = jbench.random_block_matrix(n, 128, dens, seed=2)
    pc, oc, mbr, mcr = jplan_spgemm_ex(ja, ja)
    assert ({k: rec["counters"][k] for k in ("blocks", "pairs", "out", "row_caps")}
            == dict(blocks=int(ja.nnz), pairs=pc, out=oc, row_caps=[mbr, mcr]))
    from jax.sharding import Mesh
    import jax

    jad = jdist.distribute(ja, Mesh(np.asarray(jax.devices()[:1]), ("p",)))
    jplan = jroute.plan_route(jad, jad, 1)
    sidx = np.asarray(jplan.send_idx[0][0])
    assert rec["counters"]["send_panel"] == int((sidx >= 0).sum())
    assert rec["counters"]["passthrough"] == bool((sidx == np.arange(len(sidx))).all())
    assert rec["counters"]["stages"] == list(jplan.stages)

    # The later-stage accumulate: D on the product's support, the port's
    # aligned and generic accumulates against the JAX package's generic one.
    A, _, _, _, _, _, D = profile_routed_1dev.setup(n, dens, DEV)
    assert_same_matrix(A, ja, rtol=0, atol=0)
    jd = jx.BlockMatrix(ids=jnp.asarray(D.ids.numpy()), data=jnp.asarray(D.data.numpy()),
                        nnz=jnp.asarray(int(D.nnz), jnp.int32), n_rows=n, n_cols=n,
                        block_size=128)
    jplan_u = jmake_plan(ja, ja, pc, accum_ids=jd.ids, out_cap=oc)
    want, jinfo = jspgemm(ja, ja, pair_cap=pc, out_cap=oc, row_caps=(mbr, mcr), accum=jd,
                          plan=jplan_u, backend="xla")
    assert not bool(jinfo.plan_mismatch)
    plan_u = hbsm.make_plan(A, A, pc, accum_ids=D.ids, out_cap=oc)
    for aligned in (True, False):
        got, info = hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr), accum=D, plan=plan_u,
                                accum_aligned=aligned)
        assert not bool(info.plan_mismatch)
        assert_same_matrix(got, want)
