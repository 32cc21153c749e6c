"""One SP2 step at B3 in parts, on one CUDA card: the counterpart of
``scripts/profile_b3.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.profile_b3

Input: the bench's B3 (4096^2, band 256, b = 128, symmetrised, scaled to
unit Frobenius norm, shifted by I/2; `bench.b3_input`), its capacity
profile over 5 steps at tau = 1e-6, and the iterate after 2 planned-free
steps (`purify_scan`), the densest structure the step's parts see.  The
parts, each measured alone (`scripts/ablation.py`):

  scan            the 5-step `purify_scan` (a step is a fifth of it)
  sp2_step        one eager step on the step-2 iterate
  spgemm+accum    the step's multiply: symbolic, numeric, the union and
                  the beta gather-add
  spgemm plain    the product alone
  spgemm plan=    the product on a frozen symbolic plan (numeric only)
  truncate        norms, keep mask and one compaction (tau 1e-30)
  trace

and the differences the JAX script prints: symbolic + union = accum -
plan; the union merge = accum - plain; the repack + blend residue =
step - accum - truncate - trace.  Checks: the profile's per-step pairs
and caps as the JAX package computes them (at the configured size), and
the planned product bitwise equal to the unplanned one.

`main(device="cpu", n=1024, bw=64)` runs every part at a small size on
the CPU, where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.bench import b3_input
from hierarchical_block_sparse_lib_tpu_torch.models.purification import sp2_step
from hierarchical_block_sparse_lib_tpu_torch.ops.norms import trace
from hierarchical_block_sparse_lib_tpu_torch.ops.truncate import truncate
from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import log

# B3's capacity profile as the JAX package computes it (on the CPU,
# profile_purify(..., backend="xla") on bench.py's B3 input), keyed by
# (n, bw, steps, tau).
EXPECTED = {
    (4096, 256, 5, 1e-6): dict(
        per_step_pairs=[750, 2292, 4498, 4498, 4498], pair_cap=4498, out_cap=644, cap=424,
        row_caps=[13, 25]),
}


def setup(n: int, bw: int, steps: int, tau: float, device):
    """(A, its capacity profile, the iterate after 2 steps)."""
    A = b3_input(n, bw, device)
    prof = hbsm.profile_purify(A, steps, tau, target_trace=n / 2)
    X2, _ = hbsm.purify_scan(A, 2, tau, target_trace=n / 2, **prof.kwargs())
    return A, prof, X2


def main(argv=None, device=None, n: int = 4096, bw: int = 256, steps: int = 5,
         tau: float = 1e-6) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("profile_b3: no CUDA device; nothing to run")
        return 2
    run = Run("profile_b3", dev)
    A, prof, X2 = setup(n, bw, steps, tau, dev)
    run.counters.update(
        blocks=int(A.nnz), per_step_pairs=list(prof.per_step_pairs),
        per_step_out=list(prof.per_step_out), per_step_kept=list(prof.per_step_kept),
        pair_cap=prof.pair_cap, out_cap=prof.out_cap, cap=prof.cap,
        row_caps=list(prof.row_caps), iterate_nnz=int(X2.nnz), iterate_cap=X2.cap)
    log(f"B3 {n}^2 band {bw}: caps pair={prof.pair_cap} out={prof.out_cap} cap={prof.cap} "
        f"rows={prof.row_caps} per-step pairs={prof.per_step_pairs}; step-2 iterate "
        f"nnz={int(X2.nnz)} cap={X2.cap}")
    want = EXPECTED.get((n, bw, steps, tau))
    if want is not None:
        got = {k: run.counters[k] for k in want}
        run.check("profile equal to the JAX package's", got == want, f"{got} vs {want}")

    pc, oc, rc = prof.pair_cap, prof.out_cap, prof.row_caps
    kw = dict(target_trace=n / 2, **prof.kwargs())
    plan = hbsm.make_plan(X2, X2, pc)
    planned, info_p = hbsm.spgemm(X2, X2, pc, oc, row_caps=rc, plan=plan)
    plain, info = hbsm.spgemm(X2, X2, pc, oc, row_caps=rc)
    run.check("planned spgemm bitwise equal to unplanned",
              torch.equal(planned.ids, plain.ids) and torch.equal(planned.data, plain.data)
              and not bool(info_p.plan_mismatch))
    run.measure({
        "scan": lambda: hbsm.purify_scan(A, steps, tau, **kw),
        "sp2_step": lambda: sp2_step(X2, tau, pair_cap=pc, out_cap=oc, target_trace=n / 2,
                                     cap=prof.cap, row_caps=rc),
        "spgemm+accum": lambda: hbsm.spgemm(X2, X2, pc, oc, row_caps=rc, accum=X2, alpha=1.0,
                                            beta=-0.5),
        "spgemm plain": lambda: hbsm.spgemm(X2, X2, pc, oc, row_caps=rc),
        "spgemm plan=": lambda: hbsm.spgemm(X2, X2, pc, oc, row_caps=rc, plan=plan),
        "truncate": lambda: truncate(X2, 1e-30),
        "trace": lambda: trace(X2),
    })
    run.difference("sp2_step (scan / steps)", ["scan"], scale=1.0 / steps)
    run.difference("symbolic + union (accum - plan)", ["spgemm+accum"], ["spgemm plan="])
    run.difference("union merge (accum - plain)", ["spgemm+accum"], ["spgemm plain"])
    run.difference("repack + blend residue", ["sp2_step"], ["spgemm+accum", "truncate", "trace"])
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
