"""Plain reference of SP2 density-matrix purification (Niklasson, PRB 66,
155115 (2002)) of a water cluster's model Fock matrix, the input both
sides get, and the work of a call.

The deployment (``configs/sp2_water2048_321g_leaf32.json``) is the one
the Ergo linear-scaling SCF program runs: a cluster of water molecules
at liquid density in the 3-21G basis (13 functions a molecule), ordered
by space, its orthogonalised Fock matrix F purified by SP2 with leaf
blocks dropped at Frobenius norm <= tau after every step.  There is no
SCF code here, so F is a model Hamiltonian drawn from the seed, with the
constants under the configuration's ``assumed``:

- molecules: a simple cubic lattice at the density's spacing, each site
  moved by U(-jitter, jitter) per coordinate, the `molecules` sites
  nearest the centre kept and ordered by the Morton code of their
  lattice cells; 13 consecutive basis functions a molecule;
- on a molecule: F_mm = Q_m diag(eps + delta_m) Q_m^T with Q_m a random
  orthogonal matrix, eps the occupied and virtual levels, delta_m
  U(-delta, delta);
- between molecules closer than r_cut: F_mm' = c0 exp(-(r - r0) / lambda)
  G_mm', G iid N(0, 1), and F_m'm its transpose.

The reference scan works on the dense matrix: X0 = (rho I - F) / (2 rho)
with rho = max_i sum_j |F_ij|; every step takes s = [trace X > N_occ],
X <- (2s - 1) X^2 + (2 - 2s) X, then zeroes every leaf block of
Frobenius norm <= tau, following its own branches.  Its support is the
blocks it keeps; its pairs are counted on that support (``counts.py``).

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import counts, gen
from benchmark.reference import common

ROWS = 4096  # matrix rows per pass of the chunked norms


@dataclass
class Member:
    """One Fock matrix: sorted int64 leaf-block ids on the host, float32
    [nnz, b, b] payloads on the device."""

    n: int
    b: int
    ids: np.ndarray
    data: torch.Tensor


def model(cfg: dict) -> dict:
    """The model Hamiltonian's constants, with the derived sizes."""
    a = dict(cfg["assumed"])
    occ = np.asarray(a["occupied_levels_eh"], dtype=np.float64)
    vir = np.linspace(a["virtual_low_eh"], a["virtual_high_eh"], a["virtual_levels"])
    a["levels"] = np.concatenate([occ, vir])
    a["per_molecule"] = a["levels"].size
    return a


def morton3(cells: np.ndarray) -> np.ndarray:
    """Morton code of non-negative integer 3-D cells [m, 3] (10 bits each)."""
    code = np.zeros(cells.shape[0], dtype=np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((cells[:, axis] >> bit) & 1).astype(np.int64) << (3 * bit + axis)
    return code


def cluster(cfg: dict, rng: np.random.Generator) -> np.ndarray:
    """float64 [molecules, 3] centres in Angstrom, in Morton order."""
    a = model(cfg)
    m = cfg["molecules"]
    spacing = a["density_per_a3"] ** (-1.0 / 3.0)
    half = int(np.ceil((3.0 * m / (4.0 * np.pi)) ** (1.0 / 3.0))) + 2
    axis = np.arange(-half, half + 1)
    cells = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    pos = cells * spacing + rng.uniform(-a["jitter_a"], a["jitter_a"], cells.shape)
    near = np.argsort(np.linalg.norm(pos, axis=1), kind="stable")[:m]
    order = np.argsort(morton3(cells[near] + half), kind="stable")
    return pos[near[order]]


def fock(cfg: dict, seed: int, member: int = 0):
    """F's sorted int64 leaf-block ids and float64 [nnz, b, b] blocks,
    drawn on the host from (seed, member)."""
    a = model(cfg)
    b, k = cfg["block_size"], a["per_molecule"]
    n = cfg["molecules"] * k
    nb = n // b
    rng = gen.host_rng(seed, member, 0)
    pos = cluster(cfg, rng)
    mols = pos.shape[0]
    q, r = np.linalg.qr(rng.standard_normal((mols, k, k)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    lev = a["levels"][None, :] + rng.uniform(-a["delta_eh"], a["delta_eh"], (mols, k))
    on = np.einsum("mik,mk,mjk->mij", q, lev, q)
    on = 0.5 * (on + on.transpose(0, 2, 1))
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    i, j = np.nonzero(np.triu(d < a["r_cut_a"], 1))
    scale = a["c0_eh"] * np.exp(-(d[i, j] - a["r0_a"]) / a["lambda_a"])
    off = scale[:, None, None] * rng.standard_normal((i.size, k, k))
    # Every element of F once: the molecule blocks do not overlap.
    mi = np.concatenate([np.arange(mols), i, j])
    mj = np.concatenate([np.arange(mols), j, i])
    vals = np.concatenate([on, off, off.transpose(0, 2, 1)])
    rows = (mi[:, None, None] * k + np.arange(k)[None, :, None]).repeat(k, 2).reshape(-1)
    cols = (mj[:, None, None] * k + np.arange(k)[None, None, :]).repeat(k, 1).reshape(-1)
    bid = (rows // b) * nb + cols // b
    ids, inv = np.unique(bid, return_inverse=True)
    data = np.zeros((ids.size, b * b))
    data[inv, (rows % b) * b + cols % b] = vals.reshape(-1)
    return ids.astype(np.int64), data.reshape(-1, b, b)


def make_inputs(cfg: dict, pool: int, seed: int, device) -> list[Member]:
    """`pool` Fock matrices, each drawn on the host and moved once."""
    n = cfg["molecules"] * model(cfg)["per_molecule"]
    out = []
    for m in range(pool):
        ids, data = fock(cfg, seed, m)
        out.append(Member(n, cfg["block_size"], ids,
                          torch.as_tensor(data, dtype=torch.float32).to(device)))
    return out


def _norms2(x: torch.Tensor, nb: int) -> torch.Tensor:
    """[nb, nb] squared Frobenius norm of every leaf block, a band of
    block rows at a time."""
    b = x.shape[0] // nb
    step = max(1, ROWS // b)
    return torch.cat([x[i * b:(i + step) * b].view(-1, b, nb, b).square().sum(dim=(1, 3))
                      for i in range(0, nb, step)])


def _sq_norm(x: torch.Tensor, y: torch.Tensor | None = None) -> float:
    """||x - y||_F^2 (||x||_F^2 without `y`) in float64, a band of rows at
    a time."""
    total = 0.0
    for i in range(0, x.shape[0], ROWS):
        band = x[i:i + ROWS].double()
        if y is not None:
            band = band - y[i:i + ROWS]
        total += float(band.square().sum())
    return total


def reference(cfg: dict, m: Member, mode: str = "f64", steps: int | None = None,
              last_idempotency: bool = False) -> dict:
    """The reference SP2 scan of `m` at `mode`'s precision, `steps` steps
    (the configuration's by default).  Returns D's ids and blocks, each
    step's pairs, input trace, branch and kept blocks, and the
    idempotency ||X^2 - X||_F / ||X||_F of every step's output (the last
    one only with `last_idempotency`, at one product more)."""
    a = model(cfg)
    steps = a["n_steps"] if steps is None else steps
    nb, b = m.n // m.b, m.b
    dt = common.work_dtype(mode)
    tau2, n_occ = float(a["tau"]) ** 2, float(a["n_occ"])
    x = common.dense(m.ids, m.data, nb, dt)
    rho = x.abs().sum(1).max()
    x.mul_(-0.5 / rho).diagonal().add_(0.5)
    mask = counts.block_mask(m.ids, nb) | np.eye(nb, dtype=bool)
    out = dict(pairs=[], trace=[], up=[], kept=[], idempotency=[], rho=float(rho),
               nnz0=int(mask.sum()))
    for k in range(steps + (1 if last_idempotency else 0)):
        y = common.matmul(x, x, mode)
        if k > 0:
            out["idempotency"].append((_sq_norm(y, x) / _sq_norm(x)) ** 0.5)
        if k == steps:
            break
        t = float(x.diagonal().sum())
        up = t > n_occ
        out["pairs"].append(counts.pairs(mask, mask))
        out["trace"].append(t)
        out["up"].append(up)
        if not up:
            y.mul_(-1.0).add_(x, alpha=2.0)
        del x
        keep = _norms2(y, nb) > tau2
        y.view(nb, b, nb, b).mul_(keep.to(dt)[:, None, :, None])
        x, mask = y, keep.cpu().numpy()
        out["kept"].append(int(mask.sum()))
        del y
    ids = counts.mask_ids(mask)
    out.update(ids=ids, data=common.blocks(x, ids, nb), final_trace=float(x.diagonal().sum()),
               tau=float(a["tau"]), n_occ=n_occ)
    return out


def work(cfg: dict, m: Member, ref: dict) -> dict:
    """FLOPs of the call's products, 2 b^3 times every step's X X pairs
    counted on the reference's own iterates, and its least bytes: every
    step reads its input iterate once and writes its output once."""
    held = [ref["nnz0"]] + ref["kept"]
    return dict(pairs=sum(ref["pairs"]), flops=counts.gemm_flops(sum(ref["pairs"]), m.b),
                bytes=counts.block_bytes(sum(held[:-1]) + sum(held[1:]), m.b))


def answer(ref: dict) -> dict:
    """A reference result read as an answer of the program (the control)."""
    return dict(ids=ref["ids"], data=ref["data"], pairs=sum(ref["pairs"]),
                trace=ref["final_trace"], replans=0)


def compare(got: dict, ref: dict) -> dict:
    """The numbers `correct` is decided on, for one answer."""
    d_err, _ = common.compare_blocks(got["ids"], got["data"], ref["ids"], ref["data"])
    g_ids, r_ids = np.asarray(got["ids"], np.int64), np.asarray(ref["ids"], np.int64)
    orphan = 0.0
    for ids, data, other in ((g_ids, got["data"], r_ids), (r_ids, ref["data"], g_ids)):
        alone = torch.as_tensor(np.flatnonzero(~np.isin(ids, other)), device=data.device)
        if alone.numel():
            norms = data[alone].double().square().sum(dim=(1, 2)).sqrt()
            orphan = max(orphan, float(norms.max()) / ref["tau"])
    pairs = sum(ref["pairs"])
    return dict(d_err=d_err, orphan_over_tau=orphan,
                trace_err=abs(float(got["trace"]) - ref["n_occ"]) / ref["n_occ"],
                pairs_rel_diff=abs(int(got["pairs"]) - pairs) / max(pairs, 1),
                replans=int(got["replans"]))
