"""Density-matrix purification demo, the port's counterpart of
``examples/purification_demo.py``: a banded model Hamiltonian, its
spectrum mapped into [0, 1], 40 SP2 steps with norm truncation at fixed
capacities, and the result held against the spectral projector.  Run on
a CUDA card:

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.purification_demo [n] [nocc]

`main(argv, device="cpu")` runs it on the CPU (kernels' plain versions)
and returns the relative Frobenius distance to the projector (None for n
above 4096, where the dense eigensolve is skipped).  Run as a script it
exits non-zero when that distance is above `TOL`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.models.purification import purify_scan
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import Counters

STEPS = 40
# Relative Frobenius distance to the projector at the default n = 1024:
# 40 steps at tau = 1e-7 leave about 1e-6 (8.2e-7 on the CPU).  Smaller n
# have smaller gaps at the Fermi level and need more steps.
TOL = 1e-4


def hamiltonian(n: int, seed: int = 0):
    """COO triplets of a symmetric model Hamiltonian of bandwidth 8."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for k in range(0, 9):
        v = rng.standard_normal(n - k).astype(np.float32) * 0.3
        i = np.arange(n - k)
        rows += [i, i + k] if k else [i]
        cols += [i + k, i] if k else [i]
        vals += [v, v] if k else [v]
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def main(argv=None, device=None) -> float | None:
    """Run the demo; returns the relative distance to the projector."""
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1024
    nocc = int(argv[1]) if len(argv) > 1 else n // 4
    b = 128 if n % 128 == 0 else 16

    H = hbsm.from_coo(*hamiltonian(n), n, block_size=b, device=device)
    dH = hbsm.to_dense(H).double()
    w = torch.linalg.eigvalsh(dH)
    lo, hi = float(w[0]), float(w[-1])
    # X0 = (hi I - H) / (hi - lo): spectrum in (0, 1), occupied states high.
    X = hbsm.add(
        hbsm.eye(n, b, cap=H.cap + n // b, device=H.device), H,
        alpha=hi / (hi - lo), beta=-1.0 / (hi - lo),
    )
    pc, oc, mbr, mcr = plan_spgemm_ex(X, X)
    nb = -(-n // b)
    # The iterate fills in mid-purification before truncation thins it
    # again: the dense bound when it is small, else a multiple of the plan.
    pair_cap = min(nb**3, max(16 * pc, 1))
    out_cap = min(nb * nb, max(16 * oc, 1))
    mbr, mcr = min(nb, 8 * mbr), min(nb, 8 * mcr)

    cnt = Counters()
    with cnt.timed():
        Xf, stats = purify_scan(
            X, STEPS, tau=1e-7, pair_cap=pair_cap, out_cap=out_cap,
            target_trace=nocc, row_caps=(mbr, mcr),
        )
        got = hbsm.to_dense(Xf).double()  # waits for the device
    cnt.record(stats)
    if cnt.overflows:
        raise AssertionError(f"purification overflowed ({cnt.overflows} flags set)")
    idem = float(torch.linalg.norm(got @ got - got))
    print(f"n={n} nocc={nocc} block={b} device={got.device}")
    print(f"steps={STEPS}  trace={float(torch.trace(got)):.3f}  ||X^2-X||_F={idem:.2e}")
    print(f"block multiplies={cnt.n_block_multiplies:,}  wall={cnt.wall_s:.2f}s "
          "(first call: includes kernel loading)")
    if n > 4096:
        return None
    _, vv = torch.linalg.eigh(dH)
    proj = vv[:, :nocc] @ vv[:, :nocc].T
    err = float(torch.linalg.norm(got - proj) / max(float(torch.linalg.norm(proj)), 1e-30))
    print(f"vs dense spectral projector: rel err {err:.2e} (tolerance {TOL:.0e})")
    return err


if __name__ == "__main__":
    err = main()
    sys.exit(0 if err is None or err <= TOL else 1)
