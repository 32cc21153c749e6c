"""The planned SP2 scan's fixed costs per step, ablated on one CUDA card:
the counterpart of ``scripts/profile_scan.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.profile_scan

Input (`build_input`): a symmetric 6144^2 iterate at 55% block density
(the mask symmetrised, so ~80% of the blocks), seed 7, 3 planned steps at
tau = 1e-7, target trace n / 4.  Variants of the same planned trajectory
(`make_variant`), each measured alone (`scripts/ablation.py`):

  bare     the planned multiply with constant alpha/beta; the carry is the
           product's head cut to the iterate's capacity
  notrace  bare + truncate(tau, cap=)
  notrunc  bare + the trace and its blend
  full     trace, blend, multiply, truncate: the planned `sp2_step`

beside the real planned `purify_scan` and `eager`, the same steps as N
calls of `sp2_step` outside it.  Per step: trace/blend = full - notrace,
truncate = full - notrunc, scan vs eager = purify_scan - eager, and bare.
The variants with a constant blend or no truncation leave the planned
trajectory, so their plans flag `plan_mismatch` by design (the shapes and
the work are the same); the flag is printed per variant, and `full` must
be clean and bitwise equal to `purify_scan`.  The JAX script's
`full_unroll` has no counterpart: the port's scan is a Python loop,
unrolled already.  A variant that fails ends the run with a non-zero exit.

Then the compaction micro-benchmark at the profile's capacities: the
scatter (`index_copy_` of the kept blocks into zeros) against the gather
(an int32 inverse slot map, then one `index_select`), equal results, each
with its effective GB/s beside the card's 3.35 TB/s.

`main(device="cpu", n=768)` runs all of it at a small size on the CPU,
where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import resolve_device
from hierarchical_block_sparse_lib_tpu_torch.models.purification import sp2_step
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import trace
from hierarchical_block_sparse_lib_tpu_torch.ops.repack import repack
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import HBM_BYTES, log

VARIANTS = ("bare", "notrace", "notrunc", "full")
# The profile's per-step pairs as the JAX package computes them (on the
# CPU, profile_purify(..., backend="xla")), keyed by (n, density, seed,
# steps, tau).
EXPECTED = {(6144, 0.55, 7, 3, 1e-7): [72736, 110592, 110592]}


def build_input(n: int = 6144, density: float = 0.55, seed: int = 7, device=None):
    """The JAX script's symmetric iterate, 0.52 I - M, from the same
    numpy calls."""
    rng = np.random.default_rng(seed)
    nb = n // 128
    m = rng.standard_normal((n, n)).astype(np.float32) * 0.02
    mask = rng.random((nb, nb)) < density
    mask = mask | mask.T
    m = m * np.kron(mask, np.ones((128, 128), np.float32))
    ms = (m + m.T) / 2
    ms = ms / max(1.0, 1.05 * np.abs(ms).sum(1).max())
    x0 = 0.52 * np.eye(n, dtype=np.float32) - ms
    return hbsm.from_dense(torch.from_numpy(x0).to(resolve_device(device)), block_size=128)


def make_variant(variant: str, prof, plans, nocc, x_cap, n_steps: int, tau):
    """A callable running `n_steps` planned steps of `variant` from
    `x_cap`: (the final iterate, plan_mismatch per step)."""
    pc, oc, cap, rc = prof.pair_cap, prof.out_cap, prof.cap, prof.row_caps

    def step(x, pl):
        if variant in ("full", "notrunc"):
            s = (trace(x) > nocc).to(x.dtype)
            alpha, beta = 2.0 * s - 1.0, 2.0 - 2.0 * s
        else:
            alpha, beta = -1.0, 2.0
        y, info = hbsm.spgemm(x, x, pc, oc, row_caps=rc, accum=x, alpha=alpha, beta=beta,
                              plan=pl)
        if variant in ("full", "notrace"):
            y, _ = truncate(y, tau, cap=cap)
        else:
            y = dataclasses.replace(x, ids=y.ids[:cap], data=y.data[:cap],
                                    nnz=torch.clamp(y.nnz, max=cap))
        return y, info.plan_mismatch

    def run():
        x, flags = x_cap, []
        for k in range(n_steps):
            x, flag = step(x, plans.step(k))
            flags.append(flag)
        return x, torch.stack(flags)

    return run


def compaction(oc: int, cap: int, b: int, device):
    """The truncation's compaction two ways on `oc` random blocks, 70%
    kept into `cap` slots: {"scatter": fn, "gather": fn} over the same
    (padded) input.  The scatter writes each kept block into its slot of
    zeros; the gather inverts the slot map with a small int32 scatter and
    reads every slot once (slot `oc` of the input is a zero block)."""
    d0 = torch.from_numpy(np.random.default_rng(0).standard_normal((oc, b, b)).astype(np.float32))
    keep0 = torch.from_numpy(np.random.default_rng(1).random(oc) < 0.7)
    d = torch.cat([d0, torch.zeros((1, b, b))]).to(device)
    keep0 = keep0.to(device)

    def slots():
        keep = keep0 & (d[:oc, 0, 0] > -1e30)
        return torch.where(keep, torch.cumsum(keep, 0) - 1, cap).clamp_(max=cap)

    def scatter():
        out = torch.zeros((cap + 1, b, b), dtype=d.dtype, device=device)
        out.index_copy_(0, slots(), d[:oc])
        return out[:cap]

    def gather():
        src = torch.full((cap + 1,), oc, dtype=torch.int32, device=device)
        src[slots()] = torch.arange(oc, dtype=torch.int32, device=device)
        return torch.index_select(d, 0, src[:cap])

    return {"scatter": scatter, "gather": gather}


def main(argv=None, device=None, n: int = 6144, density: float = 0.55, seed: int = 7,
         n_steps: int = 3, tau: float = 1e-7) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("profile_scan: no CUDA device; nothing to run")
        return 2
    run = Run("profile_scan", dev)
    X = build_input(n, density, seed, dev)
    nocc = X.n_rows // 4
    prof = hbsm.profile_purify(X, n_steps, tau, target_trace=nocc)
    plans = hbsm.plan_purify(X, n_steps, tau, prof, target_trace=nocc)
    x_cap = repack(X, prof.cap)
    run.counters.update(blocks=int(X.nnz), cap=prof.cap, out_cap=prof.out_cap,
                        pair_cap=prof.pair_cap, per_step_pairs=list(prof.per_step_pairs))
    log(f"config: {n}^2, {int(X.nnz)} blocks, cap={prof.cap} out_cap={prof.out_cap} "
        f"pair_cap={prof.pair_cap} pairs/step={prof.per_step_pairs}")
    want = EXPECTED.get((n, density, seed, n_steps, tau))
    if want is not None:
        run.check("per-step pairs equal to the JAX package's",
                  list(prof.per_step_pairs) == want, f"{list(prof.per_step_pairs)} vs {want}")

    calls = {v: make_variant(v, prof, plans, nocc, x_cap, n_steps, tau) for v in VARIANTS}
    kw = dict(target_trace=nocc, **prof.kwargs())
    calls["purify_scan"] = lambda: hbsm.purify_scan(X, n_steps, tau, plans=plans, **kw)

    def eager():
        x = x_cap
        for k in range(n_steps):
            x, _ = sp2_step(x, tau, pair_cap=prof.pair_cap, out_cap=prof.out_cap,
                            target_trace=nocc, cap=prof.cap, row_caps=prof.row_caps,
                            plan=plans.step(k))
        return x

    calls["eager"] = eager
    flags = {}
    for v in VARIANTS:
        x, mism = calls[v]()
        flags[v] = [bool(f) for f in mism.cpu()]
        log(f"{v:8s}: plan_mismatch per step {flags[v]}"
            + (" (by design: the variant leaves the planned trajectory)" if any(flags[v]) else ""))
        if v == "full":
            x_full = x
    run.counters["plan_mismatch"] = flags
    xs, st = calls["purify_scan"]()
    run.check("full and purify_scan clean",
              not any(flags["full"]) and not bool(st.plan_mismatch.any()),
              f"full {flags['full']}, purify_scan {st.plan_mismatch.tolist()}")
    run.check("full bitwise equal to purify_scan",
              torch.equal(x_full.ids, xs.ids) and torch.equal(x_full.data, xs.data))
    xe = eager()
    run.check("eager bitwise equal to purify_scan",
              torch.equal(xe.ids, xs.ids) and torch.equal(xe.data, xs.data))

    run.measure(calls, reps=5)
    per = 1.0 / n_steps
    for v in (*VARIANTS, "purify_scan", "eager"):
        run.difference(f"{v} per step", [v], scale=per)
    run.difference("trace/blend per step (full - notrace)", ["full"], ["notrace"], scale=per)
    run.difference("truncate per step (full - notrunc)", ["full"], ["notrunc"], scale=per)
    run.difference("scan vs eager per step (purify_scan - eager)", ["purify_scan"], ["eager"],
                   scale=per)

    comp = compaction(prof.out_cap, prof.cap, 128, dev)
    run.check("scatter and gather compactions equal",
              torch.equal(comp["scatter"](), comp["gather"]()))
    run.measure({f"compact/{k}": fn for k, fn in comp.items()})
    nbytes = 2 * prof.out_cap * 128 * 128 * 4
    rates = {}
    for k in comp:
        t = run.parts[f"compact/{k}"]["ms"]
        rates[k] = None if t is None else nbytes / t / 1e6
        log(f"compact/{k}: "
            + ("not measured" if t is None else
               f"{t:.3f} ms, {rates[k]:.0f} GB/s effective "
               f"({100 * rates[k] * 1e9 / HBM_BYTES:.1f}% "
               f"of {HBM_BYTES / 1e12:.2f} TB/s)"))
    return run.finish(compact_gb_per_s=rates)


if __name__ == "__main__":
    sys.exit(main())
