"""Sparsity-aware distributed SpGEMM: plan-driven block routing (port of
``parallel/route.py``).

The ring of `parallel.dist` rotates whole B shards P-1 times, so a banded
workload ships mostly useless blocks at every stage.  Here each shard
receives only the B blocks its local products touch, planned exactly on
the host from the id structure.

Scheme (the 1-D block-row partition of `dist.distribute`):

- dst d needs B block rows ``K_d = {col(k) : A_d stores a block (i, k)}``;
- stage t in [0, n_stages): dst d receives from src s = (d + t) mod P the
  subset of s's B blocks whose row is in K_d: one `ppermute`, with the
  permutation s -> (s - t) mod P, of packed panels (gathered by the
  host-planned local indices, SENTINEL-padded, sorted, so the receiver
  feeds them straight into the local SpGEMM);
- stages whose routed traffic is zero for every (src, dst) pair are
  dropped at plan time;
- the exchange of stage t+1 is issued before stage t's local products,
  so on several cards the copy overlaps them.

Every capacity is per-stage exact, and the plan carries the traffic and
balance evidence: blocks routed against the ring's (P-1) * nnz(B),
per-shard pair counts, per-stage caps.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from hierarchical_block_sparse_lib_tpu_torch.core import assembly
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL, BlockMatrix
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows
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
    ids_only,
    pmax,
    ppermute,
    psum,
    shard_geometry,
    with_shards,
)
from hierarchical_block_sparse_lib_tpu_torch.runtime import native


@dataclass(frozen=True)
class RoutePlan:
    """Host-side exact routing plan for one distributed SpGEMM structure,
    reusable while the structure holds (plan once, run many)."""

    n_dev: int
    # Ring offsets carrying traffic, ascending (0 = the local stage).
    stages: tuple  # tuple[int]
    # Per kept stage: int32[P, cap_t] local B indices each SOURCE sends to
    # dst (src - t) mod P; -1 padding (sorted indices first, pad last).
    send_idx: tuple  # tuple[np.ndarray]
    # Per kept stage: exact max-over-shards (pair, out) caps.
    stage_pair_caps: tuple
    stage_out_caps: tuple
    # Per kept stage: exact max-over-shards (max_b_row, max_c_row), the
    # row caps that send each local stage to the row-panel kernel.
    stage_row_caps: tuple
    # Exact per-shard result capacity (max over shards).
    out_cap: int
    # Most blocks in a row of the final per-shard union: the c-side row
    # cap of the fused per-stage accumulate.
    union_c_row_max: int
    total_pairs: int
    per_device_pairs: tuple  # len P: load-balance evidence
    # Traffic in blocks of b*b elements between shards.  Stage t=0 is the
    # local panel (no transfer) and is not counted; blocks_ring counts the
    # ring's P-1 rotations.
    blocks_routed: int
    blocks_ring: int  # (P-1) * nnz(B)
    per_stage_blocks: tuple

    def summary(self) -> str:
        bal = (
            max(self.per_device_pairs) / max(1.0, np.mean(self.per_device_pairs))
            if self.per_device_pairs else 0.0
        )
        return (
            f"route plan: P={self.n_dev} stages={list(self.stages)} "
            f"(skipped {self.n_dev - len(self.stages)}), routed "
            f"{self.blocks_routed} blocks vs ring {self.blocks_ring} "
            f"({self.blocks_routed / max(1, self.blocks_ring):.1%}), "
            f"pairs/device max/mean={bal:.2f}"
        )


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _pad_send(send_idx) -> tuple:
    out = []
    for s in send_idx:
        padded = np.full((s.shape[0], _next_pow2(s.shape[1])), -1, np.int32)
        padded[:, : s.shape[1]] = s
        out.append(padded)
    return tuple(out)


def bucket_plan(plan: RoutePlan) -> RoutePlan:
    """Round every static capacity of a plan up to a power of two (stage
    pair/out/row caps, result cap, send-panel widths), so consecutive
    purification steps whose envelope matches share capacities."""
    return dataclasses.replace(
        plan,
        send_idx=_pad_send(plan.send_idx),
        stage_pair_caps=tuple(_next_pow2(c) for c in plan.stage_pair_caps),
        stage_out_caps=tuple(_next_pow2(c) for c in plan.stage_out_caps),
        stage_row_caps=tuple((_next_pow2(br), _next_pow2(cr)) for br, cr in plan.stage_row_caps),
        out_cap=_next_pow2(plan.out_cap),
        union_c_row_max=_next_pow2(plan.union_c_row_max),
    )


def need_rows(a_ids: np.ndarray, a_nbc: int, nb_rows: int) -> np.ndarray:
    """bool[P, nb_rows]: the B block rows each shard's A blocks read."""
    mask = np.zeros((a_ids.shape[0], nb_rows), bool)
    for d in range(a_ids.shape[0]):
        ids = a_ids[d][a_ids[d] != SENTINEL]
        mask[d, np.unique(ids % a_nbc)] = True
    return mask


def plan_route(a: DistBlockMatrix, b: DistBlockMatrix, n_dev: int) -> RoutePlan:
    """The exact routing plan from distributed ids (`DistBlockMatrix.
    stacked_ids`, [P, cap_local], global ids), on the host: O(P * nnz)
    for the send lists plus P^2 calls of the C++ planner."""
    a_ids = a.stacked_ids()
    b_ids = b.stacked_ids()
    if a_ids.ndim != 2 or a_ids.shape[0] != n_dev:
        raise ValueError(f"plan_route needs ids [{n_dev}, cap], got {a_ids.shape}")
    a_nbc, b_nbc = a.nb_cols, b.nb_cols
    sent = int(SENTINEL)
    need_mask = need_rows(a_ids, a_nbc, b.nb_rows)
    b_rows_local = [b_ids[s][b_ids[s] != sent] // b_nbc for s in range(n_dev)]

    # Raw per-(stage, src) send lists (local indices into src's arrays).
    raw = [[None] * n_dev for _ in range(n_dev)]  # [t][src]
    stage_sizes = np.zeros(n_dev, np.int64)
    for t in range(n_dev):
        for s in range(n_dev):
            d = (s - t) % n_dev
            idx = np.nonzero(need_mask[d, b_rows_local[s]])[0].astype(np.int32)
            raw[t][s] = idx
            stage_sizes[t] += idx.size
    stages = [t for t in range(n_dev) if stage_sizes[t] > 0]

    send_idx, stage_pair_caps, stage_out_caps, stage_row_caps = [], [], [], []
    per_stage_blocks = []
    per_dev_pairs = np.zeros(n_dev, np.int64)
    blocks_routed = 0
    for t in stages:
        cap_t = max(max(raw[t][s].size for s in range(n_dev)), 1)
        sidx = np.full((n_dev, cap_t), -1, np.int32)
        pc_t = oc_t = br_t = cr_t = 0
        for s in range(n_dev):
            idx = raw[t][s]
            sidx[s, : idx.size] = idx
            if t != 0:  # stage 0 gathers locally: no transfer
                blocks_routed += int(idx.size)
        per_stage_blocks.append(int(stage_sizes[t]))
        # Exact per-(stage, dst) plan of the local multiply, with the row
        # maxima that let the stage run on the row-panel kernel.
        for d in range(n_dev):
            s = (d + t) % n_dev
            idx = raw[t][s]
            sub_ids = b_ids[s][idx] if idx.size else np.empty(0, np.int32)
            np_pairs, np_out, mbr, mcr = native.plan_spgemm_ex(
                a_ids[d], sub_ids, a_nbc, b.nb_rows, b_nbc
            )
            pc_t, oc_t = max(pc_t, np_pairs), max(oc_t, np_out)
            br_t, cr_t = max(br_t, mbr), max(cr_t, mcr)
            per_dev_pairs[d] += np_pairs
        send_idx.append(sidx)
        stage_pair_caps.append(max(pc_t, 1))
        stage_out_caps.append(max(oc_t, 1))
        stage_row_caps.append((max(br_t, 1), max(cr_t, 1)))

    # Exact final capacity per shard: the local plan against the union of
    # everything the shard receives (with the union's widest row).
    out_cap = union_cr = 1
    for d in range(n_dev):
        recv = [b_ids[(d + t) % n_dev][raw[t][(d + t) % n_dev]] for t in stages
                if raw[t][(d + t) % n_dev].size]
        allb = np.sort(np.concatenate(recv)) if recv else np.empty(0, np.int32)
        _, n_out, _, u_cr = native.plan_spgemm_ex(a_ids[d], allb, a_nbc, b.nb_rows, b_nbc)
        out_cap, union_cr = max(out_cap, n_out), max(union_cr, u_cr)

    nnz_b = int((b_ids != sent).sum())
    return RoutePlan(
        n_dev=n_dev,
        stages=tuple(stages),
        send_idx=tuple(send_idx),
        stage_pair_caps=tuple(stage_pair_caps),
        stage_out_caps=tuple(stage_out_caps),
        stage_row_caps=tuple(stage_row_caps),
        out_cap=int(out_cap),
        union_c_row_max=int(union_cr),
        total_pairs=int(per_dev_pairs.sum()),
        per_device_pairs=tuple(int(x) for x in per_dev_pairs),
        blocks_routed=int(blocks_routed),
        blocks_ring=int((n_dev - 1) * nnz_b),
        per_stage_blocks=tuple(per_stage_blocks),
    )


def panel_ids(b_ids: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The ids of the panel that local indices `idx` (-1 padded) gather
    from one shard's ids."""
    return np.where(idx >= 0, b_ids[np.maximum(idx, 0)], SENTINEL).astype(np.int32)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a card through pinned memory, so the
    copy does not make the host wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


def send_tensors(send_idx, b: DistBlockMatrix) -> tuple:
    """Per kept stage, per source shard: its valid send indices (int64) on
    the source's device.  Padding is last, so the valid ones lead."""
    return tuple(
        tuple(upload(s[src][s[src] >= 0].astype(np.int64), b.shards[src].device)
              for src in range(s.shape[0]))
        for s in send_idx
    )


@dataclass(frozen=True)
class FrozenRoutePlan:
    """Per-(stage, shard) frozen symbolic plans for the routed SpGEMM:
    every stage of `dist_spgemm_routed` then runs numeric-only (no
    symbolic sorts, no union merge) at per-stage exact capacities.  Built
    by `freeze_route_plan`; valid while both operands keep their id
    structure (self-checked per stage through plan_mismatch)."""

    route: RoutePlan
    # Per kept stage: one SymbolicPlan per shard, on the shard's device.
    stage_plans: tuple
    # Aligned regime: every stage's union is the final per-shard union, so
    # the row-panel kernel accumulates in-kernel (each slot starts from
    # the running C) and the per-stage gather-add goes.  Needs >= 2 kept
    # stages and the row-panel kernel (freeze_route_plan decides).
    aligned: bool = False
    # `send_tensors` of the route's send lists, built once.
    send: tuple = ()


def freeze_route_plan(
    a: DistBlockMatrix, b: DistBlockMatrix, plan: RoutePlan, aligned: bool | None = None,
) -> FrozenRoutePlan:
    """Freeze the per-stage symbolic structure of a routed SpGEMM.

    For each kept stage k and shard d, runs `make_plan` against d's A and
    the exact panel d receives at stage k, with the running per-shard
    union as the accumulator structure, so the frozen chain reproduces
    `_routed_stages`' fused accumulates exactly.  One loop over shards
    takes the place of the reference's `jax.vmap`.

    `aligned` (default: at least two kept stages and the reference's
    row-panel rule, `pallas_gemm_rows.reference_rows_rule`, takes the leaf
    at the plan's row caps) replans every stage against the final union."""
    n_dev = plan.n_dev
    b_ids = b.stacked_ids()
    out_cap = plan.out_cap
    a_sh = a.shards

    def stage_plan(k, u):
        t = plan.stages[k]
        out = []
        for d in range(n_dev):
            s = (d + t) % n_dev
            pan = upload(panel_ids(b_ids[s], plan.send_idx[k][s]), a_sh[d].device)
            out.append(make_plan(a_sh[d], ids_only(pan, b), plan.stage_pair_caps[k],
                                 accum_ids=u[d], out_cap=out_cap))
        return tuple(out)

    # Running per-shard union, from the empty accumulator of _routed_stages.
    u = [torch.full((out_cap,), SENTINEL, dtype=torch.int32, device=s.device) for s in a_sh]
    stage_plans = []
    for k in range(len(plan.stages)):
        sp = stage_plan(k, u)
        u = [p.out_ids for p in sp]
        stage_plans.append(sp)
    if aligned is None:
        # The reference's rule, at the row caps it passes: the largest
        # stage's B row cap and the final union's C row cap.
        max_b_row = max((rc[0] for rc in plan.stage_row_caps), default=1)
        aligned = (
            len(plan.stages) >= 2
            and bool(plan.stage_row_caps)
            and pallas_gemm_rows.reference_rows_rule(
                a.block_size, a.dtype, max_b_row, plan.union_c_row_max, b.nb_cols)
        )
    if aligned:
        stage_plans = [stage_plan(k, u) for k in range(len(plan.stages))]
    return FrozenRoutePlan(route=plan, stage_plans=tuple(stage_plans), aligned=aligned,
                           send=send_tensors(plan.send_idx, b))


def pack(b_shards, send_k, width: int) -> tuple:
    """Every source's outgoing panel for one stage: (ids, blocks) per
    source, `width` slots, its blocks gathered by its send indices and
    SENTINEL/zero padded."""
    ids_out, data_out = [], []
    for bs, idx in zip(b_shards, send_k):
        n = idx.shape[0]
        ids = torch.full((width,), SENTINEL, dtype=torch.int32, device=bs.device)
        ids[:n] = bs.ids[idx]
        data = torch.empty((width,) + tuple(bs.data.shape[1:]), dtype=bs.dtype, device=bs.device)
        torch.index_select(bs.data, 0, idx, out=data[:n])
        data[n:].zero_()
        ids_out.append(ids)
        data_out.append(data)
    return ids_out, data_out


def _routed_stages(
    a: DistBlockMatrix,
    b: DistBlockMatrix,
    send,
    plan: RoutePlan,
    mesh: Mesh,
    axis: str,
    out_cap: int,
    backend: str,
    precision: str,
    stage_plans=None,
    aligned: bool = False,
):
    """The shared stage loop: software-pipelined routed panel exchange,
    per-stage local SpGEMM and union accumulate.  With `aligned`
    (FrozenRoutePlan.aligned) every stage's output structure is the final
    union and the accumulate happens inside the row-panel kernel.
    Returns per shard (C, pairs, overflow, stage-plan mismatch: False
    unless stale `stage_plans` are given)."""
    stages = list(plan.stages)
    n_dev = plan.n_dev
    a_sh, b_sh = a.shards, b.shards
    bg = shard_geometry(b)

    def exchange(k):
        """Gather every source's panel for kept stage k and ppermute it to
        its destination: the received (ids, blocks) per shard."""
        ids, data = pack(b_sh, send[k], plan.send_idx[k].shape[1])
        t = stages[k]
        if t == 0:
            return ids, data
        perm = [(s, (s - t) % n_dev) for s in range(n_dev)]
        return ppermute(mesh, ids, axis, perm), ppermute(mesh, data, axis, perm)

    aligned = bool(aligned and stage_plans is not None)
    if aligned:
        # Start from the final union with zero blocks: every stage, the
        # first too, accumulates in-kernel on top.
        c = []
        for d, s in enumerate(a_sh):
            u_ids = stage_plans[0][d].out_ids
            c.append(BlockMatrix(
                ids=u_ids,
                data=torch.zeros((out_cap, s.block_size, s.block_size), dtype=s.dtype,
                                 device=s.device),
                nnz=(u_ids != SENTINEL).sum().to(torch.int32),
                n_rows=s.n_rows, n_cols=b.n_cols, block_size=s.block_size,
            ))
    else:
        c = [None] * n_dev
    pairs = [torch.zeros((), dtype=torch.int32, device=s.device) for s in a_sh]
    ovf = [torch.zeros((), dtype=torch.bool, device=s.device) for s in a_sh]
    mism = [torch.zeros((), dtype=torch.bool, device=s.device) for s in a_sh]
    row_caps = None

    # Software pipeline: issue exchange k+1 before computing with panel k.
    recv = exchange(0) if stages else None
    for k in range(len(stages)):
        nxt = exchange(k + 1) if k + 1 < len(stages) else None
        if plan.stage_row_caps:
            row_caps = (plan.stage_row_caps[k][0], plan.union_c_row_max)
        ids_r, data_r = recv
        for d, s in enumerate(a_sh):
            panel = BlockMatrix(ids=ids_r[d], data=data_r[d],
                                nnz=(ids_r[d] != SENTINEL).sum().to(torch.int32), **bg)
            # Fused accumulate at the final union capacity: C = A@panel + C
            # in one pass.  The first stage's accumulator is the empty C,
            # so unaligned it skips the accumulate (the product's support
            # is the union of it with nothing).
            c[d], info = spgemm(
                s, panel,
                pair_cap=plan.stage_pair_caps[k],
                out_cap=out_cap,
                row_caps=row_caps,
                backend="rows" if aligned else backend,
                precision=precision,
                accum=c[d] if (aligned or k > 0) else None,
                accum_aligned=aligned,
                plan=None if stage_plans is None else stage_plans[k][d],
            )
            pairs[d] = pairs[d] + info.n_block_pairs
            ovf[d] = ovf[d] | overflow_flags(info)
            mism[d] = mism[d] | info.plan_mismatch
        recv = nxt
    if c[0] is None:  # no kept stage: A or B holds no block
        c = [assembly.empty(s.n_rows, b.n_cols, s.block_size, out_cap, dtype=s.dtype,
                            device=s.device) for s in a_sh]
    return c, pairs, ovf, mism


def _unfreeze(plan):
    if isinstance(plan, FrozenRoutePlan):
        return plan, plan.route
    return None, plan


def _route_stats(mesh, axis, plan, pairs, ovf, mism) -> dict:
    dev0 = pairs[0].device
    return dict(
        n_block_pairs=psum(mesh, pairs, axis)[0],
        per_device_pairs=torch.stack([p.to(dev0, non_blocking=True) for p in pairs]),
        overflow=pmax(mesh, ovf, axis)[0],
        plan_mismatch=pmax(mesh, mism, axis)[0],
        blocks_routed=plan.blocks_routed,
        blocks_ring=plan.blocks_ring,
        n_stages=len(plan.stages),
        n_stages_skipped=plan.n_dev - len(plan.stages),
    )


def dist_spgemm_routed(
    a: DistBlockMatrix,
    b: DistBlockMatrix,
    mesh: Mesh,
    plan,
    alpha=1.0,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    out_cap: int | None = None,
):
    """Distributed C = alpha * A @ B shipping only the needed B panels.

    `plan` from `plan_route` on the same distributed structure, or a
    `FrozenRoutePlan` (`freeze_route_plan`) to run every stage
    numeric-only.  Returns (C distributed, stats dict: total pairs,
    per-shard pairs, the overflow flag, plan_mismatch (a stale frozen
    plan), the plan's traffic and stage counts).  Each exchange is issued
    one stage ahead of the products that consume it."""
    frozen, plan = _unfreeze(plan)
    if mesh.shape[axis] != plan.n_dev:
        raise ValueError(f"plan for {plan.n_dev} shards, mesh axis {axis!r} has {mesh.shape[axis]}")
    a.on(mesh), b.on(mesh)
    out_cap = plan.out_cap if out_cap is None else out_cap
    send = frozen.send if frozen is not None else send_tensors(plan.send_idx, b)
    c, pairs, ovf, mism = _routed_stages(
        a, b, send, plan, mesh, axis, out_cap, backend, precision,
        stage_plans=None if frozen is None else frozen.stage_plans,
        aligned=frozen is not None and frozen.aligned,
    )
    if not alpha_is_one_static(alpha):
        c = [basic.scale(x, alpha) for x in c]
    return with_shards(a, c), _route_stats(mesh, axis, plan, pairs, ovf, mism)


def expect_mismatch(x: DistBlockMatrix, expect_ids) -> list | None:
    """Per shard: True where x's ids differ from `expect_ids` ([P, cap],
    the structure a plan was built for), or None without `expect_ids`.  A
    shape difference raises."""
    if expect_ids is None:
        return None
    want = (len(x.shards), x.cap)
    if tuple(expect_ids.shape) != want:
        raise ValueError(f"plan built for iterate ids {expect_ids.shape}, got {want}")
    exp = np.asarray(expect_ids, np.int32)
    return [torch.any(s.ids != upload(exp[d], s.device)) for d, s in enumerate(x.shards)]


def dist_sp2_step_routed(
    x: DistBlockMatrix,
    mesh: Mesh,
    plan,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    expect_ids: np.ndarray | None = None,
):
    """One distributed SP2 step over the routed exchange: X @ X ships only
    the X panels each shard's products touch (plan from
    ``plan_route(xd, xd, P)`` on the current structure, or its
    `freeze_route_plan` for numeric-only stages), then the blend,
    shard-local truncation and repack.

    `cap` is the per-shard iterate capacity after truncation (default the
    plan's union out_cap).  `expect_ids` ([P, cap_local]): the iterate
    structure the plan was built for; the step then checks it on the
    device and reports ``stats["plan_mismatch"]``: a stale plan routes
    wrong panels and must be loud.  Returns (X_next distributed, stats)."""
    frozen, plan = _unfreeze(plan)
    if mesh.shape[axis] != plan.n_dev:
        raise ValueError(f"plan for {plan.n_dev} shards, mesh axis {axis!r} has {mesh.shape[axis]}")
    x.on(mesh)
    out_cap = plan.out_cap
    x_cap = out_cap if cap is None else cap
    exp_mism = expect_mismatch(x, expect_ids)
    send = frozen.send if frozen is not None else send_tensors(plan.send_idx, x)
    t = psum(mesh, [_trace(s) for s in x.shards], axis)
    x2, pairs, ovf, mism = _routed_stages(
        x, x, send, plan, mesh, axis, out_cap, backend, precision,
        stage_plans=None if frozen is None else frozen.stage_plans,
        aligned=frozen is not None and frozen.aligned,
    )
    ys = []
    for d, s in enumerate(x.shards):
        y, over = sp2_blend(x2[d], s, t[d], target_trace, tau, x_cap)
        ys.append(y)
        ovf[d] = ovf[d] | over
        if exp_mism is not None:
            mism[d] = mism[d] | exp_mism[d]
    stats = _route_stats(mesh, axis, plan, pairs, ovf, mism)
    return with_shards(x, ys), dict(trace=t[0], **stats)


@dataclass(frozen=True)
class RoutedPurifyPlans:
    """Per-step routing plans of a purification whose structure sequence
    repeats (the SCF regime): one profiling pass records every step's
    route and capacity envelope, and later runs plan nothing.

    `x_ids[i]` is the iterate structure step i's plan was built for; the
    planned run checks it on the device every step (`plan_mismatch`)."""

    step_plans: tuple  # tuple[RoutePlan | FrozenRoutePlan]
    x_ids: tuple  # tuple[np.ndarray [P, cap_local_i]]
    x_caps: tuple  # tuple[int] post-truncation per-shard capacity

    @property
    def n_steps(self) -> int:
        return len(self.step_plans)


def plan_purify_routed(
    x: DistBlockMatrix,
    mesh: Mesh,
    n_steps: int,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    bucket: bool = True,
    freeze: bool = True,
) -> RoutedPurifyPlans:
    """Profiling pass: the routed purification once, replanning each step
    as the unplanned `dist_purify_routed` does, recording each step's
    (bucketed, frozen) plan and the iterate structure it was built for.
    The structure depends on the values only through truncation's keep
    decisions, so the plans stay valid while those repeat, and the
    planned run reports any drift."""
    n_dev = mesh.shape[axis]
    step_plans, x_ids, x_caps = [], [], []
    for _ in range(n_steps):
        plan = plan_route(x, x, n_dev)
        if bucket:
            plan = bucket_plan(plan)
        if freeze:
            plan = freeze_route_plan(x, x, plan)
        step_plans.append(plan)
        x_ids.append(x.stacked_ids())
        x, _ = dist_sp2_step_routed(
            x, mesh, plan, tau, target_trace=target_trace, cap=cap, axis=axis,
            backend=backend, precision=precision,
        )
        x_caps.append(x.cap)
    return RoutedPurifyPlans(step_plans=tuple(step_plans), x_ids=tuple(x_ids),
                             x_caps=tuple(x_caps))


def dist_purify_routed(
    x: DistBlockMatrix,
    mesh: Mesh,
    n_steps: int,
    tau,
    target_trace=0.0,
    cap: int | None = None,
    axis: str = "p",
    backend: str = "auto",
    precision: str = "highest",
    bucket: bool = True,
    plans: RoutedPurifyPlans | None = None,
):
    """`n_steps` distributed SP2 iterations on the routed exchange,
    replanning the route each step as the iterate's structure evolves
    (`bucket` rounds each plan's capacities to powers of two).  With
    `plans` (`plan_purify_routed`): no host planning, each step on its
    recorded plan with the on-device id check.  Returns (X_final
    distributed, per-step stats dicts)."""
    n_dev = mesh.shape[axis]
    stats = []
    if plans is not None:
        if plans.n_steps < n_steps:
            raise ValueError(f"plans cover {plans.n_steps} steps, need {n_steps}")
        for i in range(n_steps):
            x, st = dist_sp2_step_routed(
                x, mesh, plans.step_plans[i], tau, target_trace=target_trace,
                cap=plans.x_caps[i], axis=axis, backend=backend, precision=precision,
                expect_ids=plans.x_ids[i],
            )
            stats.append(st)
        return x, stats
    for _ in range(n_steps):
        plan = plan_route(x, x, n_dev)
        if bucket:
            plan = bucket_plan(plan)
        x, st = dist_sp2_step_routed(
            x, mesh, plan, tau, target_trace=target_trace, cap=cap, axis=axis,
            backend=backend, precision=precision,
        )
        stats.append(st)
    return x, stats
