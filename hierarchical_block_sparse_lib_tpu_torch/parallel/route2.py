"""Two-level (host x chip) sparsity-aware block routing (port of
``parallel/route2.py``).

The flat router (`parallel.route`) treats the mesh as one axis, so a B
panel needed by k chips of a remote host crosses the slow inter-host link
k times.  Here the mesh is ``(host, chip)`` and routing has two levels:

- inter-host ("DCN" in the reference): for host-stage ht each source chip
  packs one share per destination host, the subset of its B blocks that
  any chip of host (host(s) - ht) mod H needs, and one `ppermute` over
  the "host" axis ships it: a block crosses hosts at most once per
  destination host;
- intra-host ("ICI"): an `all_gather` over the "chip" axis hands every
  chip its host's shares, in chip order.

The local compute is the flat router's: one exact-capacity SpGEMM per
(host-stage, source chip) against that chip's share, fused into the
union accumulator.  Shares arrive sorted with SENTINEL padding last,
because chips own ascending block-row ranges and each share keeps its
source's id order.  Traffic: `dcn_blocks` (two-level) against
`dcn_blocks_flat` (what the flat plan ships across hosts) against
`blocks_ring`; dcn_blocks <= dcn_blocks_flat always.

Inputs are distributed flat, ``[P]`` shards in host-major order (the
layout of `dist.distribute` over P = H * C shards).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core import assembly
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL, BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.ops import basic
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import trace as _trace
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import (
    alpha_is_one_static,
    make_plan,
    spgemm,
)
from hierarchical_block_sparse_lib_tpu_torch.parallel.dist import overflow_flags, sp2_blend
from hierarchical_block_sparse_lib_tpu_torch.parallel.mesh import (
    DistBlockMatrix,
    Mesh,
    all_gather,
    ids_only,
    make_grid,
    pmax,
    ppermute,
    psum,
    shard_geometry,
    with_shards,
)
from hierarchical_block_sparse_lib_tpu_torch.parallel.route import (
    _next_pow2,
    _pad_send,
    expect_mismatch,
    need_rows,
    pack,
    panel_ids,
    send_tensors,
    upload,
)
from hierarchical_block_sparse_lib_tpu_torch.runtime import native


@dataclass(frozen=True)
class Route2Plan:
    """Host-side exact two-level routing plan (reusable while both
    operands keep their id structure, like `route.RoutePlan`)."""

    n_hosts: int
    n_chips: int
    # Host-ring offsets carrying traffic, ascending (0 = the intra-host
    # stage: no inter-host move, the all_gather only).
    stages: tuple
    # Per kept stage: int32[P, share_cap_t] local B indices each source
    # chip sends toward host (host(src) - ht) mod H; -1 padding last.
    send_idx: tuple
    # Per kept stage, per source-chip slot cc in [0, C): exact
    # max-over-destinations (pair, out, max_b_row, max_c_row) of the local
    # multiply against that share; None where no destination has a pair.
    stage_caps: tuple
    out_cap: int
    # Most blocks in a row of the final per-shard union.
    union_c_row_max: int
    total_pairs: int
    per_device_pairs: tuple
    # Traffic in block copies of b*b elements.
    dcn_blocks: int  # two-level: each share crosses hosts once
    dcn_blocks_flat: int  # the flat plan's inter-host copies
    ici_blocks: int  # copies received through intra-host all_gathers
    blocks_ring: int  # (P-1) * nnz(B)
    per_stage_blocks: tuple

    def summary(self) -> str:
        return (
            f"route2 plan: {self.n_hosts}x{self.n_chips} stages="
            f"{list(self.stages)}, DCN {self.dcn_blocks} blocks vs flat "
            f"{self.dcn_blocks_flat} "
            f"({self.dcn_blocks / max(1, self.dcn_blocks_flat):.1%}), "
            f"ICI {self.ici_blocks}, ring {self.blocks_ring}"
        )


def plan_route_2level(
    a: DistBlockMatrix, b: DistBlockMatrix, n_hosts: int, n_chips: int
) -> Route2Plan:
    """The exact two-level plan from distributed ids ([P, cap_local], P =
    n_hosts * n_chips, host-major)."""
    H, C = n_hosts, n_chips
    P_ = H * C
    a_ids = a.stacked_ids()
    b_ids = b.stacked_ids()
    if a_ids.ndim != 2 or a_ids.shape[0] != P_:
        raise ValueError(f"plan_route_2level needs ids [{P_}, cap], got {a_ids.shape}")
    a_nbc, b_nbc = a.nb_cols, b.nb_cols
    sent = int(SENTINEL)
    need_mask = need_rows(a_ids, a_nbc, b.nb_rows)
    need_mask_host = np.stack([need_mask[h * C:(h + 1) * C].any(axis=0) for h in range(H)])
    b_rows_local = [b_ids[s][b_ids[s] != sent] // b_nbc for s in range(P_)]

    # The flat plan's inter-host copies (each dst chip gets its own).
    dcn_flat = 0
    for t in range(P_):
        for s in range(P_):
            d = (s - t) % P_
            if d // C != s // C:
                dcn_flat += int(need_mask[d, b_rows_local[s]].sum())

    # Shares: raw[ht][s] = local indices s sends toward host (host(s) - ht) mod H.
    raw = [[None] * P_ for _ in range(H)]
    stage_sizes = np.zeros(H, np.int64)
    for ht in range(H):
        for s in range(P_):
            hd = (s // C - ht) % H
            idx = np.nonzero(need_mask_host[hd, b_rows_local[s]])[0].astype(np.int32)
            raw[ht][s] = idx
            stage_sizes[ht] += idx.size
    stages = [ht for ht in range(H) if stage_sizes[ht] > 0]

    send_idx, stage_caps, per_stage_blocks = [], [], []
    per_dev_pairs = np.zeros(P_, np.int64)
    dcn_blocks = ici_blocks = 0
    for ht in stages:
        cap_t = max(max(raw[ht][s].size for s in range(P_)), 1)
        sidx = np.full((P_, cap_t), -1, np.int32)
        for s in range(P_):
            idx = raw[ht][s]
            sidx[s, : idx.size] = idx
            if ht != 0:
                dcn_blocks += int(idx.size)
            # The all_gather hands each of the other C-1 siblings a copy.
            ici_blocks += (C - 1) * int(idx.size)
        send_idx.append(sidx)
        per_stage_blocks.append(int(stage_sizes[ht]))
        # Exact caps per (ht, source-chip slot): dst chip d multiplies with
        # the share packed by chip cc of host (host(d) + ht) % H.
        caps_t = []
        for cc in range(C):
            pc_t = oc_t = br_t = cr_t = 0
            any_pairs = False
            for d in range(P_):
                s = ((d // C + ht) % H) * C + cc
                idx = raw[ht][s]
                sub_ids = b_ids[s][idx] if idx.size else np.empty(0, np.int32)
                np_pairs, np_out, mbr, mcr = native.plan_spgemm_ex(
                    a_ids[d], sub_ids, a_nbc, b.nb_rows, b_nbc
                )
                pc_t, oc_t = max(pc_t, np_pairs), max(oc_t, np_out)
                br_t, cr_t = max(br_t, mbr), max(cr_t, mcr)
                per_dev_pairs[d] += np_pairs
                any_pairs = any_pairs or np_pairs > 0
            caps_t.append(
                (max(pc_t, 1), max(oc_t, 1), max(br_t, 1), max(cr_t, 1)) if any_pairs else None
            )
        stage_caps.append(tuple(caps_t))

    # Exact output capacity: the union of everything each shard receives.
    out_cap = union_cr = 1
    for d in range(P_):
        recv = []
        for ht in stages:
            hs = (d // C + ht) % H
            for cc in range(C):
                idx = raw[ht][hs * C + cc]
                if idx.size:
                    recv.append(b_ids[hs * C + cc][idx])
        allb = np.sort(np.concatenate(recv)) if recv else np.empty(0, np.int32)
        _, n_out, _, u_cr = native.plan_spgemm_ex(a_ids[d], allb, a_nbc, b.nb_rows, b_nbc)
        out_cap, union_cr = max(out_cap, n_out), max(union_cr, u_cr)

    nnz_b = int((b_ids != sent).sum())
    return Route2Plan(
        n_hosts=H,
        n_chips=C,
        stages=tuple(stages),
        send_idx=tuple(send_idx),
        stage_caps=tuple(stage_caps),
        out_cap=int(out_cap),
        union_c_row_max=int(union_cr),
        total_pairs=int(per_dev_pairs.sum()),
        per_device_pairs=tuple(int(x) for x in per_dev_pairs),
        dcn_blocks=int(dcn_blocks),
        dcn_blocks_flat=int(dcn_flat),
        ici_blocks=int(ici_blocks),
        blocks_ring=int((P_ - 1) * nnz_b),
        per_stage_blocks=tuple(per_stage_blocks),
    )


def make_mesh_2level(n_hosts: int, n_chips: int, device=None) -> Mesh:
    """("host", "chip") mesh of n_hosts * n_chips shards, host-major (chip
    varies fastest), placed as `dist.make_mesh` places the same count."""
    return make_grid((n_hosts, n_chips), ("host", "chip"), device)


def bucket_plan_2level(plan: Route2Plan) -> Route2Plan:
    """Round every static capacity up to a power of two (share widths,
    per-(stage, chip) caps, union out_cap): the two-level `bucket_plan`."""
    stage_caps = tuple(
        tuple(None if c is None else tuple(_next_pow2(v) for v in c) for c in per_cc)
        for per_cc in plan.stage_caps
    )
    return dataclasses.replace(
        plan,
        send_idx=_pad_send(plan.send_idx),
        stage_caps=stage_caps,
        out_cap=_next_pow2(plan.out_cap),
        union_c_row_max=_next_pow2(plan.union_c_row_max),
    )


@dataclass(frozen=True)
class FrozenRoute2Plan:
    """Per-(host-stage, source-chip, shard) frozen symbolic plans for the
    two-level routed SpGEMM: every share multiply runs numeric-only.
    Built by `freeze_route2_plan`; staleness is checked per share through
    MultiplyInfo.plan_mismatch."""

    route: Route2Plan
    # Per kept stage: per source-chip slot, None where the stage_caps entry
    # is None, else one SymbolicPlan per shard (flat order, on its device).
    stage_plans: tuple
    # `route.send_tensors` of the route's send lists, built once.
    send: tuple = ()


def _share_source(d: int, ht: int, cc: int, H: int, C: int) -> int:
    """Flat rank of the chip whose share shard d multiplies with at
    host-stage ht, source-chip slot cc."""
    return ((d // C + ht) % H) * C + cc


def freeze_route2_plan(
    a: DistBlockMatrix, b: DistBlockMatrix, plan: Route2Plan
) -> FrozenRoute2Plan:
    """Freeze the per-share symbolic structure of a two-level routed
    SpGEMM: for each kept host-stage, source-chip slot and shard, run
    `make_plan` against the shard's A and the exact share it consumes,
    threading the running per-shard union as the accumulator structure,
    in `_stages_2level`'s (stage, chip) order."""
    H, C = plan.n_hosts, plan.n_chips
    b_ids = b.stacked_ids()
    a_sh = a.shards
    u = [torch.full((plan.out_cap,), SENTINEL, dtype=torch.int32, device=s.device) for s in a_sh]
    stage_plans = []
    for k, ht in enumerate(plan.stages):
        per_cc = []
        for cc in range(C):
            caps = plan.stage_caps[k][cc]
            if caps is None:
                per_cc.append(None)
                continue
            per_dev = []
            for d in range(H * C):
                s = _share_source(d, ht, cc, H, C)
                pan = upload(panel_ids(b_ids[s], plan.send_idx[k][s]), a_sh[d].device)
                pl = make_plan(a_sh[d], ids_only(pan, b), caps[0], accum_ids=u[d],
                               out_cap=plan.out_cap)
                u[d] = pl.out_ids
                per_dev.append(pl)
            per_cc.append(tuple(per_dev))
        stage_plans.append(tuple(per_cc))
    return FrozenRoute2Plan(route=plan, stage_plans=tuple(stage_plans),
                            send=send_tensors(plan.send_idx, b))


def _stages_2level(
    a: DistBlockMatrix,
    b: DistBlockMatrix,
    send,
    plan: Route2Plan,
    mesh: Mesh,
    out_cap: int,
    backend: str,
    precision: str,
    host_axis: str,
    chip_axis: str,
    stage_plans=None,
):
    """The shared stage loop: the software-pipelined two-level exchange
    (inter-host ppermute, then the intra-host all_gather, one host-stage
    ahead of the products) and per-share local SpGEMMs fused into the
    union accumulator.  Returns per shard (C, pairs, overflow, plan
    mismatch)."""
    H, C = plan.n_hosts, plan.n_chips
    stages = list(plan.stages)
    a_sh = a.shards
    bg = shard_geometry(b)

    def exchange(k):
        """Pack every chip's share for host-stage k, move it across hosts
        (ht > 0), then gather the host's shares: per shard the tuple, in
        chip order, of its host's shares as (ids, blocks)."""
        ids, data = pack(b.shards, send[k], plan.send_idx[k].shape[1])
        ht = stages[k]
        if ht != 0:
            perm = [(hs, (hs - ht) % H) for hs in range(H)]
            ids = ppermute(mesh, ids, host_axis, perm)
            data = ppermute(mesh, data, host_axis, perm)
        return all_gather(mesh, ids, chip_axis), all_gather(mesh, data, chip_axis)

    c = [None] * len(a_sh)
    pairs = [torch.zeros((), dtype=torch.int32, device=s.device) for s in a_sh]
    ovf = [torch.zeros((), dtype=torch.bool, device=s.device) for s in a_sh]
    mism = [torch.zeros((), dtype=torch.bool, device=s.device) for s in a_sh]

    # Software pipeline: issue exchange k+1 before the C local multiplies
    # of stage k.
    recv = exchange(0) if stages else None
    for k in range(len(stages)):
        nxt = exchange(k + 1) if k + 1 < len(stages) else None
        ids_g, data_g = recv
        for cc in range(C):
            caps = plan.stage_caps[k][cc]
            if caps is None:
                continue  # no pair for any destination
            pc, _, mbr, _ = caps
            for d, s in enumerate(a_sh):
                share = BlockMatrix(ids=ids_g[d][cc], data=data_g[d][cc],
                                    nnz=(ids_g[d][cc] != SENTINEL).sum().to(torch.int32), **bg)
                # Fused accumulate at the union capacity; the first share
                # multiply runs without one (its accumulator is empty).
                c[d], info = spgemm(
                    s, share, pair_cap=pc, out_cap=out_cap,
                    row_caps=(mbr, plan.union_c_row_max), backend=backend,
                    precision=precision, accum=c[d], beta=1.0,
                    plan=None if stage_plans is None else stage_plans[k][cc][d],
                )
                pairs[d] = pairs[d] + info.n_block_pairs
                ovf[d] = ovf[d] | overflow_flags(info)
                mism[d] = mism[d] | info.plan_mismatch
        recv = nxt
    if c[0] is None:  # no share multiply ran: A or B holds no block
        c = [assembly.empty(s.n_rows, b.n_cols, s.block_size, out_cap, dtype=s.dtype,
                            device=s.device) for s in a_sh]
    return c, pairs, ovf, mism


def _route2_stats(mesh, both, plan, pairs, ovf, mism) -> dict:
    dev0 = pairs[0].device
    return dict(
        n_block_pairs=psum(mesh, pairs, both)[0],
        per_device_pairs=torch.stack([p.to(dev0, non_blocking=True) for p in pairs]),
        overflow=pmax(mesh, ovf, both)[0],
        plan_mismatch=pmax(mesh, mism, both)[0],
        dcn_blocks=plan.dcn_blocks,
        dcn_blocks_flat=plan.dcn_blocks_flat,
        ici_blocks=plan.ici_blocks,
        blocks_ring=plan.blocks_ring,
        n_stages=len(plan.stages),
    )


def _check_mesh(mesh: Mesh, plan: Route2Plan, host_axis: str, chip_axis: str) -> None:
    if (mesh.shape[host_axis], mesh.shape[chip_axis]) != (plan.n_hosts, plan.n_chips):
        raise ValueError(
            f"plan for {plan.n_hosts}x{plan.n_chips}, mesh "
            f"{mesh.shape[host_axis]}x{mesh.shape[chip_axis]}"
        )


def _unfreeze(plan):
    if isinstance(plan, FrozenRoute2Plan):
        return plan, plan.route
    return None, plan


def dist_spgemm_2level(
    a: DistBlockMatrix,
    b: DistBlockMatrix,
    mesh: Mesh,
    plan,
    alpha=1.0,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    out_cap: int | None = None,
):
    """Distributed C = alpha * A @ B over the two-level exchange.  Inputs
    are distributed flat over P = H * C shards (host-major); `plan` may be
    a `FrozenRoute2Plan` to run every share multiply numeric-only.
    Returns (C distributed flat, stats dict with the per-level traffic)."""
    frozen, plan = _unfreeze(plan)
    _check_mesh(mesh, plan, host_axis, chip_axis)
    a.on(mesh), b.on(mesh)
    out_cap = plan.out_cap if out_cap is None else out_cap
    send = frozen.send if frozen is not None else send_tensors(plan.send_idx, b)
    c, pairs, ovf, mism = _stages_2level(
        a, b, send, plan, mesh, out_cap, backend, precision, host_axis, chip_axis,
        stage_plans=None if frozen is None else frozen.stage_plans,
    )
    if not alpha_is_one_static(alpha):
        c = [basic.scale(x, alpha) for x in c]
    return with_shards(a, c), _route2_stats(mesh, (host_axis, chip_axis), plan, pairs, ovf, mism)


def dist_sp2_step_2level(
    x: DistBlockMatrix,
    mesh: Mesh,
    plan,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    expect_ids: np.ndarray | None = None,
):
    """One distributed SP2 step over the two-level exchange: X @ X ships
    union shares once per destination host and hands them on within the
    host, then the blend, shard-local truncation and repack.  `plan` may
    be a `FrozenRoute2Plan`; `expect_ids` ([P, cap_local]) checks the
    iterate structure the plan was built for (``stats["plan_mismatch"]``).
    Returns (X_next distributed flat, stats dict with per-level traffic)."""
    frozen, plan = _unfreeze(plan)
    _check_mesh(mesh, plan, host_axis, chip_axis)
    x.on(mesh)
    both = (host_axis, chip_axis)
    out_cap = plan.out_cap
    x_cap = out_cap if cap is None else cap
    exp_mism = expect_mismatch(x, expect_ids)
    send = frozen.send if frozen is not None else send_tensors(plan.send_idx, x)
    t = psum(mesh, [_trace(s) for s in x.shards], both)
    x2, pairs, ovf, mism = _stages_2level(
        x, x, send, plan, mesh, out_cap, backend, precision, host_axis, chip_axis,
        stage_plans=None if frozen is None else frozen.stage_plans,
    )
    ys = []
    for d, s in enumerate(x.shards):
        y, over = sp2_blend(x2[d], s, t[d], target_trace, tau, x_cap)
        ys.append(y)
        ovf[d] = ovf[d] | over
        if exp_mism is not None:
            mism[d] = mism[d] | exp_mism[d]
    stats = _route2_stats(mesh, both, plan, pairs, ovf, mism)
    return with_shards(x, ys), dict(trace=t[0], **stats)


@dataclass(frozen=True)
class Routed2PurifyPlans:
    """Per-step two-level plans of a purification whose structure sequence
    repeats: one profiling pass records every step's route, capacity
    envelope and frozen symbolic structure; later runs plan nothing."""

    step_plans: tuple  # tuple[Route2Plan | FrozenRoute2Plan]
    x_ids: tuple  # tuple[np.ndarray [P, cap_local_i]]
    x_caps: tuple  # tuple[int]

    @property
    def n_steps(self) -> int:
        return len(self.step_plans)


def plan_purify_2level(
    x: DistBlockMatrix,
    mesh: Mesh,
    n_steps: int,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    bucket: bool = True,
    freeze: bool = True,
) -> Routed2PurifyPlans:
    """Profiling pass: the two-level routed purification once, replanning
    per step, recording each step's (bucketed, frozen) plan and the
    iterate structure it was built for (`route.plan_purify_routed`'s
    two-level counterpart)."""
    H, C = mesh.shape[host_axis], mesh.shape[chip_axis]
    step_plans, x_ids, x_caps = [], [], []
    for _ in range(n_steps):
        plan = plan_route_2level(x, x, H, C)
        if bucket:
            plan = bucket_plan_2level(plan)
        if freeze:
            plan = freeze_route2_plan(x, x, plan)
        step_plans.append(plan)
        x_ids.append(x.stacked_ids())
        x, _ = dist_sp2_step_2level(
            x, mesh, plan, tau, target_trace=target_trace, cap=cap, host_axis=host_axis,
            chip_axis=chip_axis, backend=backend, precision=precision,
        )
        x_caps.append(x.cap)
    return Routed2PurifyPlans(step_plans=tuple(step_plans), x_ids=tuple(x_ids),
                              x_caps=tuple(x_caps))


def dist_purify_2level(
    x: DistBlockMatrix,
    mesh: Mesh,
    n_steps: int,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    host_axis: str = "host",
    chip_axis: str = "chip",
    backend: str = "auto",
    precision: str = "highest",
    bucket: bool = True,
    plans: Routed2PurifyPlans | None = None,
):
    """`n_steps` distributed SP2 iterations on the two-level exchange,
    replanning per step, or with `plans` (`plan_purify_2level`) no host
    planning and the per-step on-device id check.  Returns (X_final
    distributed, per-step stats dicts)."""
    H, C = mesh.shape[host_axis], mesh.shape[chip_axis]
    stats = []
    if plans is not None:
        if plans.n_steps < n_steps:
            raise ValueError(f"plans cover {plans.n_steps} steps, need {n_steps}")
        for i in range(n_steps):
            x, st = dist_sp2_step_2level(
                x, mesh, plans.step_plans[i], tau, target_trace=target_trace,
                cap=plans.x_caps[i], host_axis=host_axis, chip_axis=chip_axis,
                backend=backend, precision=precision, expect_ids=plans.x_ids[i],
            )
            stats.append(st)
        return x, stats
    for _ in range(n_steps):
        plan = plan_route_2level(x, x, H, C)
        if bucket:
            plan = bucket_plan_2level(plan)
        x, st = dist_sp2_step_2level(
            x, mesh, plan, tau, target_trace=target_trace, cap=cap, host_axis=host_axis,
            chip_axis=chip_axis, backend=backend, precision=precision,
        )
        stats.append(st)
    return x, stats
