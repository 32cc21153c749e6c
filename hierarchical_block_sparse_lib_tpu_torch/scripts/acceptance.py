"""Full-size acceptance checks on one CUDA card: the port of
``scripts/acceptance.py`` (the BASELINE.json:5 criterion: match the
reference's numerics on its test matrices).

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.acceptance

Seven checks, with acceptance.py's configurations, inputs, seeds and
tolerances: each product against a float64 oracle within `TOL` = 1e-5
relative to max|exact| (f32-faithful), purification within 1e-4
(Frobenius) of the spectral projector, and precision="default" within
2e-2.  The oracles run in torch.float64 on the checks' device: at
16384^2 the dense operand and the exact product take 2 GiB each.  Each
check prints one line, as acceptance.py's `check` does, and raises on a
failure; the run ends with ``ALL ACCEPTANCE CHECKS PASSED``, and exits
non-zero on any failure or without a card.

Each check takes its sizes as arguments whose defaults are
acceptance.py's, and `device=` (the card by default), and returns the
matrices it checked: the tests run it small on the CPU, where the
kernels' plain versions run, and hold those against the JAX package.
Importing this module runs nothing.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.bench import rel_err
from hierarchical_block_sparse_lib_tpu_torch.convert import block_matrix_from_numpy
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import resolve_device
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex, resolve_backend
from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen

TOL = 1e-5  # f32-faithful vs the f64 oracle
FLAGS = ("pair_overflow", "out_overflow", "row_overflow", "plan_mismatch")


def check(name: str, rel: float, tol: float = TOL) -> float:
    status = "OK" if rel < tol else "FAIL"
    print(f"{name}: max_rel={rel:.2e} [{status}]", flush=True)
    if not rel < tol:
        raise AssertionError(f"{name}: max_rel {rel:.2e} not below {tol:.0e}")
    return rel


def no_flags(label: str, info, flags=FLAGS[:2]) -> None:
    bad = [f for f in flags if bool(torch.as_tensor(getattr(info, f)).any())]
    if bad:
        raise AssertionError(f"{label}: {bad} set")


def banded_oracle(r, c, v, n: int, device) -> torch.Tensor:
    """The band's dense f32 matrix in float64 on `device`."""
    return torch.from_numpy(gen.dense_oracle(r, c, v, n)).to(device, torch.float64)


def scaled_random(n: int, b: int, n_blocks: int, seed: int, device):
    """`n_blocks` random blocks of N(0, 0.01) on an n x n grid of leaf b
    (acceptance.py's `mk` and its inline inputs, same RNG calls)."""
    nb = n // b
    r = np.random.default_rng(seed)
    ids = np.sort(r.choice(nb * nb, n_blocks, replace=False)).astype(np.int32)
    data = r.standard_normal((n_blocks, b, b)).astype(np.float32) * 0.1
    return block_matrix_from_numpy(ids, data, n_blocks, n_rows=n, n_cols=n, block_size=b,
                                   device=device)


def b1_banded(n: int = 4096, bw: int = 64, device=None):
    """B1 (BASELINE.json:7): banded n^2, bandwidth bw, leaf 16 coarsened to
    128-wide tiles."""
    device = resolve_device(device)
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A = hbsm.coarsen(hbsm.from_coo(r, c, v, n, block_size=16, device=device), 8)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    C, info = hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr))
    no_flags("B1 banded", info)
    dA = banded_oracle(r, c, v, n, device)
    check(f"B1 banded {n}^2 bw{bw} C=A*A", rel_err(hbsm.to_dense(C), dA @ dA))
    return C


def b2_chain(n: int = 8192, b: int = 128, dens: float = 0.05, device=None):
    """B2 (BASELINE.json:8) op chain at n^2, 5% blocks:
    D = 2*(0.5*A@B + 0.25*A)."""
    device = resolve_device(device)
    nblk = int(dens * (n // b) ** 2)
    A, B = scaled_random(n, b, nblk, 11, device), scaled_random(n, b, nblk, 12, device)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, B)
    C, info = hbsm.spgemm(A, B, pc, oc, row_caps=(mbr, mcr), alpha=0.5)
    no_flags("B2 chain", info)
    D = hbsm.scale(hbsm.add(C, A, beta=0.25), 2.0)
    dA, dB = hbsm.to_dense(A).double(), hbsm.to_dense(B).double()
    exact = 2.0 * (0.5 * (dA @ dB) + 0.25 * dA)
    del dA, dB
    check(f"B2 chain {n}^2 {dens:.0%} spgemm+add+scale", rel_err(hbsm.to_dense(D), exact))
    return D


def b3_purification(n: int = 1024, b: int = 128, nocc: int = 256, bw: int = 40,
                    steps: int = 40, device=None):
    """B3 (BASELINE.json:9): purification converges to the spectral
    projector with bounded error at tau=1e-7."""
    device = resolve_device(device)
    r, c, v = gen.banded_coo(n, bw, seed=3)
    H = hbsm.from_coo(r, c, v, n, block_size=b, device=device)
    dH = hbsm.to_dense(H).double()
    dH = (dH + dH.T) / 2
    H = hbsm.from_dense(dH.float(), block_size=b)
    w, V = torch.linalg.eigh(dH)
    lo, hi = float(w[0]), float(w[-1])
    X = hbsm.add(hbsm.eye(n, b, cap=H.cap + n // b, device=device), H,
                 alpha=hi / (hi - lo), beta=-1.0 / (hi - lo))
    nb = n // b
    Xf, stats = hbsm.purify_scan(X, steps, tau=1e-7, pair_cap=nb**3, out_cap=nb * nb,
                                 target_trace=nocc, row_caps=(nb, nb))
    no_flags("B3 purification", stats, ("pair_overflow", "out_overflow", "repack_overflow"))
    proj = V[:, :nocc] @ V[:, :nocc].T
    rel = float(torch.linalg.norm(hbsm.to_dense(Xf).double() - proj) / torch.linalg.norm(proj))
    check(f"B3 purification {n}^2 -> spectral projector (fro)", rel, 1e-4)
    return Xf


def b4_near_dense(n: int = 8192, b: int = 128, dens: float = 0.5, n_slabs: int = 4,
                  device=None):
    """B4 (BASELINE.json:10) numerics at the warm-up scale (n^2, 50% block
    density) through both the row-panel path and the column-slab tier
    that runs the configured 32768^2."""
    device = resolve_device(device)
    A = scaled_random(n, b, int(dens * (n // b) ** 2), 42, device)
    dA = hbsm.to_dense(A).double()
    exact = dA @ dA
    del dA
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    C, info = hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr))
    no_flags("B4 row-panel", info)
    check(f"B4 near-dense {n}^2 {dens:.0%} (row-panel)", rel_err(hbsm.to_dense(C), exact))
    Cs, info_s = hbsm.spgemm_colslab(A, A, n_slabs=n_slabs)
    no_flags("B4 column-slab", info_s, ("pair_overflow",))
    check(f"B4 column-slab tier ({n_slabs} slabs)", rel_err(hbsm.to_dense(Cs), exact))
    return C, Cs


def b2_leaf32_headline(n: int = 16384, bf: int = 32, dens: float = 0.05, device=None):
    """The headline path: the configured B2 (random n^2, 5% block density,
    leaf 32) through the direct `spgemm` (auto -> the fine kernel) and the
    flat-resident `fine_matmul(plan=)`, against an f64 dense oracle."""
    device = resolve_device(device)
    A = scaled_random(n, bf, int(round(dens * (n // bf) ** 2)), 2, device)
    dA = hbsm.to_dense(A).double()
    exact = dA @ dA
    del dA
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    C, info = hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr))
    no_flags("B2 leaf-32 direct", info, FLAGS[:3])
    check(f"B2 CONFIGURED {n}^2 leaf-{bf} direct (fine kernel)", rel_err(hbsm.to_dense(C), exact))
    fplan = hbsm.make_fine_plan(A, A, pc, oc, (mbr, mcr))
    Af = hbsm.fine_pack(A)
    Cf, info_f = hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), plan=fplan)
    no_flags("B2 leaf-32 fine-flat", info_f, ("plan_mismatch",))
    Cf = hbsm.fine_unpack(Cf)
    check(f"B2 CONFIGURED {n}^2 leaf-{bf} fine-flat (headline)", rel_err(hbsm.to_dense(Cf), exact))
    return C, Cf


def b1_leaf16_direct(n: int = 4096, bw: int = 64, device=None):
    """B1 at its native leaf 16 through the fine kernel (no coarsening:
    the reference's own granularity)."""
    device = resolve_device(device)
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A = hbsm.from_coo(r, c, v, n, block_size=16, device=device)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    backend = resolve_backend(16, A.dtype, A.nb_cols, pc, row_caps=(mbr, mcr))
    C, info = hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr))
    no_flags("B1 leaf-16 direct", info)
    dA = banded_oracle(r, c, v, n, device)
    check(f"B1 banded {n}^2 NATIVE leaf-16 (backend={backend})", rel_err(hbsm.to_dense(C), dA @ dA))
    return C


def precision_modes(n: int = 1024, bw: int = 48, device=None) -> dict:
    """B1's structure at n^2 through the row-panel path at "highest"
    (1e-5) and "default" (2e-2)."""
    device = resolve_device(device)
    r, c, v = gen.banded_coo(n, bw, seed=0)
    A = hbsm.coarsen(hbsm.from_coo(r, c, v, n, block_size=16, device=device), 8)
    dA = banded_oracle(r, c, v, n, device)
    exact = dA @ dA
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    out = {}
    for prec, tol in (("highest", 1e-5), ("default", 2e-2)):
        out[prec], _ = hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr), precision=prec)
        check(f"precision={prec}", rel_err(hbsm.to_dense(out[prec]), exact), tol)
    return out


CHECKS = (b1_banded, b1_leaf16_direct, b2_chain, b2_leaf32_headline, b3_purification,
          b4_near_dense, precision_modes)


def main(device=None) -> int:
    """Run the seven checks (acceptance.py's order); 2 without a card
    unless `device` names another."""
    if device is None and not torch.cuda.is_available():
        print("acceptance: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    dev = resolve_device(device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}", flush=True)
    for run in CHECKS:
        run(device=dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print("ALL ACCEPTANCE CHECKS PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
