"""Generic against symmetric planned SP2 on one CUDA card: the counterpart
of ``scripts/bench_symmetric.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.bench_symmetric

Two inputs, as the JAX script has them:

  B3-scale  bench.py's banded 4096^2 (band 256, b = 128) symmetrised and
            scaled, 0.55 I - M: 5 steps at tau = 1e-7, target n / 4;
  big-sym   `profile_scan.build_input`: 6144^2 at 55% block density, 3
            steps.

For each, `profile_purify` and `plan_purify` (generic, and symmetric:
upper-triangle products on the row-panel kernel's `triu` skip, the lower
triangle mirrored), then the planned `purify_scan` both ways, measured in
turns (`scripts/ablation.py`).  Checks: the per-step pairs of both scans
as the JAX package computes them (at the configured sizes), both scans
clean, and the symmetric iterate within 1e-5 (relative to max|X|) of the
generic one.

`main(device="cpu", n_b3=1024, bw=64, n_big=768)` runs both at small
sizes on the CPU, where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.bench import rel_err
from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.scripts.profile_scan import build_input
from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import log

TOL = 1e-5
# Per-step pairs as the JAX package computes them on the CPU ("xla"):
# profile_purify's (generic) and the planned symmetric purify_scan's
# n_block_pairs, keyed by the input's name and size.
EXPECTED = {
    ("B3-scale", 4096): dict(generic=[750, 2292, 7208, 8702, 8702],
                             symmetric=[452, 1280, 3840, 4610, 4610]),
    ("big-sym", 6144): dict(generic=[72736, 110592, 110592],
                            symmetric=[37300, 56448, 56448]),
}


def b3_scale_input(n: int = 4096, bw: int = 256, device=None):
    """bench.py's banded matrix made symmetric and scaled, 0.55 I - M,
    through the host as the JAX script does it."""
    A = gen.banded_block_matrix(n, bw, 128, device=device)
    d = hbsm.to_dense(A).cpu().numpy()
    ds = ((d + d.T) / 2).astype(np.float32)
    ds = ds / max(1.0, 1.05 * np.abs(ds).sum(1).max())
    x0 = 0.55 * np.eye(n, dtype=np.float32) - ds
    return hbsm.from_dense(torch.from_numpy(x0).to(A.device), block_size=128)


def run_ab(run: Run, X, name: str, n_steps: int, tau: float) -> None:
    nocc = X.n_rows // 4
    prof = hbsm.profile_purify(X, n_steps, tau, target_trace=nocc)
    kw = dict(target_trace=nocc, **prof.kwargs())
    plans = {sym: hbsm.plan_purify(X, n_steps, tau, prof, target_trace=nocc, symmetric=sym)
             for sym in (False, True)}
    calls = {f"{name} {'symmetric' if sym else 'generic'}":
             (lambda sym=sym: hbsm.purify_scan(X, n_steps, tau, plans=plans[sym], symmetric=sym,
                                               **kw))
             for sym in (False, True)}
    (xg, sg), (xs, ss) = (fn() for fn in calls.values())
    pairs = dict(generic=sg.n_block_pairs.tolist(), symmetric=ss.n_block_pairs.tolist())
    run.counters[name] = dict(n=X.n_rows, blocks=int(X.nnz), steps=n_steps,
                              profile_pairs=list(prof.per_step_pairs), **pairs)
    log(f"{name}: {int(X.nnz)} blocks, pairs/step {pairs}")
    run.check(f"{name} generic pairs equal the profile's",
              pairs["generic"] == list(prof.per_step_pairs))
    want = EXPECTED.get((name, X.n_rows))
    if want is not None:
        run.check(f"{name} pairs equal to the JAX package's", pairs == want, f"{pairs} vs {want}")
    flags = [f for st in (sg, ss) for f in ("pair_overflow", "out_overflow", "repack_overflow",
                                            "plan_mismatch") if bool(getattr(st, f).any())]
    run.check(f"{name} scans clean", not flags, str(flags))
    err = rel_err(hbsm.to_dense(xs), hbsm.to_dense(xg))
    run.counters[name]["symmetric_vs_generic"] = err
    run.check(f"{name} symmetric iterate within {TOL} of the generic one", err <= TOL,
              f"{err:.3e}")
    run.measure(calls)
    g, s = (run.parts[k] for k in calls)
    if g["ms"] is not None:
        log(f"{name}: symmetric vs generic = {g['ms'] / s['ms']:.2f}x (call), "
            + ("device not measured" if None in (g["device_ms"], s["device_ms"]) else
               f"{g['device_ms'] / s['device_ms']:.2f}x (device)"))
    run.difference(f"{name} symmetric - generic", [f"{name} symmetric"], [f"{name} generic"])


def main(argv=None, device=None, n_b3: int = 4096, bw: int = 256, n_big: int = 6144,
         density: float = 0.55, tau: float = 1e-7) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("bench_symmetric: no CUDA device; nothing to run")
        return 2
    run = Run("bench_symmetric", dev)
    run_ab(run, b3_scale_input(n_b3, bw, dev), "B3-scale", 5, tau)
    if run.on_card:
        torch.cuda.empty_cache()
    run_ab(run, build_input(n_big, density, 7, dev), "big-sym", 3, tau)
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
