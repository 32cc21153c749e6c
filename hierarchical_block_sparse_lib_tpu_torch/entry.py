"""The port's counterparts of the repository's ``__graft_entry__``: `entry`,
one purification-style iteration (SpGEMM C = X*X, the SP2 blend and a norm
truncation) on a banded 1024^2 matrix with 128-wide blocks, the step
`chip_smoke.py` runs first on the card; and `dryrun_multichip`, every
distributed path once over a mesh of n logical shards at tiny shapes."""

from __future__ import annotations

import math

import numpy as np

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.models.purification import sp2_step
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen


def entry(device=None):
    """(fn, (x,)): fn(x) is one SP2 step, (X', PurificationStats), on the
    input the JAX package's entry builds (1024^2, band 48, 16-blocks
    coarsened to 128, scaled by 0.01, plus I/2), on the card unless
    `device` names another."""
    n, bw = 1024, 48
    rows, cols, vals = gen.banded_coo(n, bw, seed=0)
    x = hbsm.from_coo(rows, cols, vals, n, block_size=16, device=device)
    x = hbsm.coarsen(x, 8)  # 128-blocks
    x = hbsm.scale(x, 0.01)
    x = hbsm.add(x, hbsm.eye(n, 128, device=x.device), beta=0.5, cap=x.cap + n // 128)
    pc, oc, mbr, mcr = plan_spgemm_ex(x, x)
    nb = n // 128

    def fn(x):
        return sp2_step(
            x, tau=1e-7, pair_cap=2 * pc, out_cap=2 * oc, target_trace=n / 2,
            row_caps=(min(nb, 2 * mbr), min(nb, 2 * mcr)),
        )

    return fn, (x,)


def _dense(m) -> np.ndarray:
    return hbsm.to_dense(m).cpu().numpy()


def _max_err(got, want) -> float:
    err = float(np.abs(got - want).max())
    if err >= 1e-2 * max(1.0, float(np.abs(want).max())):
        raise AssertionError(f"max err {err:.3e} against the dense oracle")
    return err


def dryrun_multichip(n_devices: int, device=None) -> list:
    """Every distributed path once over a mesh of `n_devices` logical shards
    (on the card unless `device` names another), at tiny shapes, each held
    against a dense oracle or another path: the ring (then truncation and
    the norm), the routed exchange, `dist_sp2_step`, the routed SP2 step,
    two-level routing at 2 x n/2 and 4 x n/4 hosts x chips, the planned
    two-level SP2 purification against the flat routed one, and Cannon on
    the largest square mesh of at most n shards.  Prints one OK line per
    check and returns them; raises on the first failure."""
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm
    from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, dist2d, route, route2

    mesh = dist.make_mesh(n_devices, device=device)
    dev = mesh.device(0)
    summary = []

    def ok(msg):
        summary.append(msg)
        print(msg)

    n, b = 16 * n_devices * 2, 16  # 2 block rows per shard
    rows, cols, vals = gen.banded_coo(n, 8, seed=0)
    a = hbsm.from_coo(rows, cols, vals, n, block_size=b, device=dev)
    n_pairs, n_out = plan_spgemm(a, a)
    ad = dist.distribute(a, mesh)
    d_a = gen.dense_oracle(rows, cols, vals, n)
    d_aa = d_a @ d_a

    c, pairs, ovf = dist.dist_spgemm(ad, ad, mesh, pair_cap=n_pairs, out_cap=n_out,
                                     stage_out_cap=n_out)
    t = dist.dist_truncate(c, mesh, 1e-8)
    f2 = float(dist.dist_frob_squared(t, mesh))
    if int(pairs) != n_pairs or bool(ovf) or not f2 > 0:
        raise AssertionError(f"ring: pairs {int(pairs)} of {n_pairs}, overflow {bool(ovf)}, "
                             f"frob^2 {f2}")
    err = _max_err(_dense(dist.undistribute(t)), d_aa)
    ok(f"dryrun_multichip({n_devices}): OK - {n_pairs} block pairs, frob^2={f2:.3e}, "
       f"max_err={err:.2e}")

    plan = route.plan_route(ad, ad, n_devices)
    cr, rstats = route.dist_spgemm_routed(ad, ad, mesh, plan, backend="xla")
    err_r = _max_err(_dense(dist.undistribute(cr)), d_aa)
    if (int(rstats["n_block_pairs"]) != n_pairs or bool(rstats["overflow"])
            or plan.blocks_routed > plan.blocks_ring):
        raise AssertionError(f"routed exchange: {plan.summary()}, stats {rstats}")
    ok(f"dryrun routed exchange: OK - {plan.summary()}, max_err={err_r:.2e}")

    # One distributed SP2 step: ring X@X, trace psum, local truncation.
    x0 = hbsm.scale(a, 0.5 / math.sqrt(float(hbsm.frob_squared(a))))
    x0 = hbsm.add(x0, hbsm.eye(n, b, device=dev), beta=0.5, cap=x0.cap + n // b)
    pc2, oc2 = plan_spgemm(x0, x0)
    xd = dist.distribute(x0, mesh)
    y, sstats = dist.dist_sp2_step(xd, mesh, tau=1e-8, pair_cap=pc2, out_cap=oc2,
                                   target_trace=n / 2, backend="xla")
    if bool(sstats["overflow"]):
        raise AssertionError("dist_sp2_step overflow")
    dx = _dense(dist.undistribute(xd))
    ref_y = dx @ dx if float(np.trace(dx)) > n / 2 else 2 * dx - dx @ dx
    err_y = _max_err(_dense(dist.undistribute(y)), ref_y)
    ok(f"dryrun dist_sp2_step: OK - pairs={int(sstats['n_block_pairs'])}, "
       f"trace={float(sstats['trace']):.2f}, max_err={err_y:.2e}")

    # The same step over the routed exchange.
    rplan = route.plan_route(xd, xd, n_devices)
    yr, rst = route.dist_sp2_step_routed(xd, mesh, rplan, tau=1e-8, target_trace=n / 2,
                                         backend="xla")
    if bool(rst["overflow"]):
        raise AssertionError("dist_sp2_step_routed overflow")
    err_yr = _max_err(_dense(dist.undistribute(yr)), ref_y)
    ok(f"dryrun dist_sp2_step_routed: OK - routed {rst['blocks_routed']}/{rst['blocks_ring']} "
       f"ring blocks, stages={rst['n_stages']}+{rst['n_stages_skipped']} skipped, "
       f"max_err={err_yr:.2e}")

    # Two-level host x chip routing at both factorizations.
    factorizations = []
    if n_devices % 2 == 0 and n_devices >= 4:
        factorizations.append((2, n_devices // 2))
    if n_devices % 4 == 0 and n_devices >= 8:
        factorizations.append((4, n_devices // 4))
    for h, cc in factorizations:
        mesh_hc = route2.make_mesh_2level(h, cc, device=device)
        plan2 = route2.plan_route_2level(ad, ad, h, cc)
        c2l, st2 = route2.dist_spgemm_2level(ad, ad, mesh_hc, plan2, backend="xla")
        err_2l = _max_err(_dense(dist.undistribute(c2l)), d_aa)
        if (int(st2["n_block_pairs"]) != n_pairs or bool(st2["overflow"])
                or plan2.dcn_blocks > plan2.dcn_blocks_flat):
            raise AssertionError(f"two-level {h}x{cc}: {plan2.summary()}, stats {st2}")
        ok(f"dryrun two-level routing ({h} hosts x {cc} chips): OK - DCN {plan2.dcn_blocks} "
           f"blocks (flat inter-host {plan2.dcn_blocks_flat}), ICI {plan2.ici_blocks}, "
           f"ring {plan2.blocks_ring}, max_err={err_2l:.2e}")

    # The planned two-level SP2 purification (2 steps, no host replanning,
    # frozen stages, the per-step id check) against the flat routed one.
    if factorizations:
        h, cc = factorizations[0]
        mesh_hc = route2.make_mesh_2level(h, cc, device=device)
        plans2l = route2.plan_purify_2level(xd, mesh_hc, 2, 1e-8, target_trace=n / 2,
                                            backend="xla")
        y2l, st2l = route2.dist_purify_2level(xd, mesh_hc, 2, 1e-8, target_trace=n / 2,
                                              backend="xla", plans=plans2l)
        for st in st2l:
            if bool(st["overflow"]) or bool(st["plan_mismatch"]) or (
                    st["dcn_blocks"] > st["dcn_blocks_flat"]):
                raise AssertionError(f"planned two-level purification: {st}")
        yfl, _ = route.dist_purify_routed(xd, mesh, 2, 1e-8, target_trace=n / 2, backend="xla")
        g2, gf = dist.undistribute(y2l), dist.undistribute(yfl)
        err_p2 = float(np.abs(_dense(g2) - _dense(gf)).max())
        if int(g2.nnz) != int(gf.nnz) or err_p2 >= 1e-4:
            raise AssertionError(f"two-level vs flat purification: nnz {int(g2.nnz)} vs "
                                 f"{int(gf.nnz)}, max err {err_p2:.3e}")
        ok(f"dryrun two-level SP2 purification (planned, 2 steps at {h}x{cc}): OK - per-step "
           f"DCN {[st['dcn_blocks'] for st in st2l]} <= flat "
           f"{[st['dcn_blocks_flat'] for st in st2l]}, ICI {[st['ici_blocks'] for st in st2l]}, "
           f"zero replans, max_err vs flat routed={err_p2:.2e}")

    # Cannon on the largest square mesh of at most n shards.
    p = math.isqrt(n_devices)
    if p >= 2:
        mesh2 = dist2d.make_mesh2d(p, device=device)
        a2 = dist2d.distribute2d(a, mesh2)
        c2, pairs2, ovf2 = dist2d.dist2d_spgemm(a2, a2, mesh2, pair_cap=n_pairs, out_cap=n_out,
                                                 stage_out_cap=n_out)
        t2 = dist2d.dist2d_truncate(c2, mesh2, 1e-8)
        dist2d.dist2d_frob_squared(t2, mesh2)
        if int(pairs2) != n_pairs or bool(ovf2):
            raise AssertionError(f"Cannon: pairs {int(pairs2)} of {n_pairs}, overflow {bool(ovf2)}")
        err2 = _max_err(_dense(dist2d.undistribute2d(t2)), d_aa)
        ok(f"dryrun_multichip 2D Cannon ({p}x{p}): OK - {int(pairs2)} pairs, max_err={err2:.2e}")

    print("=== dryrun_multichip summary ===")
    for line in summary:
        print(line)
    print(f"=== all {len(summary)} stages OK ===")
    return summary
