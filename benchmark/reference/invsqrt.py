"""Plain reference of the Loewdin factor S^-1/2 of a water cluster's
overlap matrix by Newton-Schulz with block truncation (Jansik, Host,
Jorgensen, Olsen, Helgaker, J. Chem. Phys. 126, 124104 (2007)), the
input both sides get, and the work of a call.

The deployment (``configs/invsqrt_water2048_321g_leaf32.json``) is the
factorisation a linear-scaling SCF program (Ergo) needs before it can
purify: the overlap matrix S of the SP2 cell's water cluster in the
3-21G basis (Binkley, Pople, Hehre, JACS 102, 939 (1980)), 13 functions
a molecule, and Z ~= S^-1/2 with leaf blocks dropped at Frobenius norm
<= tau after every step.  S is built here from the overlap integrals:

- molecules: an oxygen at each of the ``molecules`` sites nearest the
  centre of ``reference/sp2.py::cluster`` drawn at
  ``assumed["cluster_molecules"]`` (the SP2 cell's sites for the same
  seed, kept in its Morton order), each molecule turned by a uniformly
  random rotation, r(OH) and the HOH angle under the configuration's
  ``assumed``;
- basis functions by molecule, 13 to a molecule: O 1s, O 2s', O 2p'x,y,z,
  O 2s'', O 2p''x,y,z, H1 1s', H1 1s'', H2 1s', H2 1s''; exponents in
  bohr^-2, contraction coefficients of normalised primitives, as the
  configuration's ``assumed["basis_3_21g"]`` gives them;
- the overlap of s and Cartesian p primitives in closed form, in float64:
  with p = a + b, mu = a b / p, P = (a A + b B) / p and
  K = exp(-mu |A - B|^2) (pi / p)^(3/2): <s|s> = K, <s|p_x> = (P_x - B_x) K,
  <p_x|s> = (P_x - A_x) K, <p_x|p_y> = ((P_x - A_x)(P_y - B_y)
  + delta_xy / (2 p)) K; every contracted function renormalised so that
  S_ii = 1;
- pairs of molecules whose oxygens lie within ``r_cut_a``; every element
  left out is below 1e-3 tau / 32 (PERF.md).

The reference iteration works on the dense matrix: theta = max_i sum_j
|S_ij|, Z0 = I / sqrt(theta), and every step T = (3 I - Z S Z) / 2,
Z <- Z T, then zeroes every leaf block of Frobenius norm <= tau.  Its
pairs are counted on its own masks, which hold every block a product
reaches (``counts.py``), the identity in T's.

Imports torch and numpy only: nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts, gen
from benchmark.reference import common
from benchmark.reference.sp2 import ROWS, Member, _norms2, _sq_norm, cluster

BOHR_PER_A = 1.0 / 0.52917721092
PER_MOLECULE = 13
PAIRS_PER_PASS = 8192  # molecule pairs per pass of the integrals


def primitives(cfg: dict):
    """The primitives of one molecule's 13 functions, from the basis under
    ``assumed["basis_3_21g"]`` (oxygen's shells, then each hydrogen's; an
    "sp" shell gives an s and then p_x, p_y, p_z): (centre int [q], 0 the
    oxygen and 1, 2 the hydrogens; exponent [q]; Cartesian component int
    [q], -1 for s; the contraction [q, 13] of normalised primitives into
    functions)."""
    basis = cfg["assumed"]["basis_3_21g"]
    centre, alpha, comp, cols = [], [], [], []
    f = 0
    for c, element in ((0, "O"), (1, "H"), (2, "H")):
        for shell in basis[element]:
            parts = [("s", -1)] + ([("p", x) for x in range(3)] if shell["shell"] == "sp" else [])
            for kind, axis in parts:
                for a, coef in zip(shell["exponents"], shell[kind]):
                    norm = (2 * a / np.pi) ** 0.75 * (1.0 if kind == "s" else 2 * np.sqrt(a))
                    centre.append(c)
                    alpha.append(a)
                    comp.append(axis)
                    cols.append((f, coef * norm))
                f += 1
    if f != PER_MOLECULE:
        raise ValueError(f"the basis gives {f} functions a molecule, not {PER_MOLECULE}")
    contract = np.zeros((len(cols), PER_MOLECULE))
    for q, (fn, v) in enumerate(cols):
        contract[q, fn] = v
    return np.array(centre), np.array(alpha), np.array(comp), contract


def rotations(rng: np.random.Generator, m: int) -> np.ndarray:
    """[m, 3, 3] rotations drawn uniformly (QR of a Gaussian matrix, signs
    fixed, turned into SO(3))."""
    q, r = np.linalg.qr(rng.standard_normal((m, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q * np.linalg.det(q)[:, None, None]


def geometry(cfg: dict, seed: int, member: int = 0) -> np.ndarray:
    """float64 [molecules, 3 atoms (O, H1, H2), 3] positions in bohr."""
    a = cfg["assumed"]
    rng = gen.host_rng(seed, member, 0)
    # sp2.cluster reads the SP2 model's levels too; none of them is used.
    sites = cluster(dict(molecules=a["cluster_molecules"], assumed=dict(
        density_per_a3=a["density_per_a3"], jitter_a=a["jitter_a"], occupied_levels_eh=[],
        virtual_levels=0, virtual_low_eh=0.0, virtual_high_eh=0.0)), rng)
    # The central `molecules` of the cluster, still in its Morton order.
    near = np.argsort(np.linalg.norm(sites, axis=1), kind="stable")[:cfg["molecules"]]
    sites = sites[np.sort(near)]
    half = np.deg2rad(a["angle_hoh_deg"]) / 2
    local = a["r_oh_a"] * np.array([[0.0, 0.0, 0.0],
                                    [np.sin(half), 0.0, np.cos(half)],
                                    [-np.sin(half), 0.0, np.cos(half)]])
    rot = rotations(rng, sites.shape[0])
    return (sites[:, None, :] + np.einsum("mij,aj->mai", rot, local)) * BOHR_PER_A


def pair_blocks(prims, atoms_i: torch.Tensor, atoms_j: torch.Tensor) -> torch.Tensor:
    """[P, 13, 13] overlaps of the contracted (not yet renormalised)
    functions of molecules i and j, from their [P, 3, 3] atom positions
    (bohr) and `primitives(cfg)`, float64."""
    centre, alpha, comp, contract = (torch.as_tensor(v, device=atoms_i.device) for v in prims)
    ca, cb = atoms_i[:, centre], atoms_j[:, centre]  # [P, q, 3]
    a, b = alpha[:, None], alpha[None, :]
    p = a + b
    mu = a * b / p
    pc = (a[..., None] * ca[:, :, None, :] + b[..., None] * cb[:, None, :, :]) / p[..., None]
    ab2 = (ca[:, :, None, :] - cb[:, None, :, :]).square().sum(-1)
    k = torch.exp(-mu * ab2) * (np.pi / p) ** 1.5
    onehot = torch.nn.functional.one_hot(comp.clamp(min=0), 3).to(torch.float64)
    onehot = onehot * (comp >= 0)[:, None]
    is_s = (comp < 0).to(torch.float64)
    fa = ((pc - ca[:, :, None, :]) * onehot[None, :, None, :]).sum(-1) + is_s[None, :, None]
    fb = ((pc - cb[:, None, :, :]) * onehot[None, None, :, :]).sum(-1) + is_s[None, None, :]
    same = onehot @ onehot.T  # both p, one component
    prim = (fa * fb + same / (2 * p)) * k
    return torch.einsum("qf,pqr,rg->pfg", contract, prim, contract)


def overlap(cfg: dict, seed: int, device, member: int = 0) -> torch.Tensor:
    """The dense float64 [n, n] overlap matrix S of (seed, member), its
    rows by molecule in Morton order, S_ii = 1."""
    atoms = torch.as_tensor(geometry(cfg, seed, member), device=device)
    mols = atoms.shape[0]
    oxy = atoms[:, 0]
    cut = cfg["assumed"]["r_cut_a"] * BOHR_PER_A
    i, j = torch.nonzero(torch.triu(torch.cdist(oxy, oxy) < cut), as_tuple=True)
    n = mols * PER_MOLECULE
    prims = primitives(cfg)
    s = torch.zeros((mols, PER_MOLECULE, mols, PER_MOLECULE), dtype=torch.float64, device=device)
    for lo in range(0, i.numel(), PAIRS_PER_PASS):
        ii, jj = i[lo:lo + PAIRS_PER_PASS], j[lo:lo + PAIRS_PER_PASS]
        blk = pair_blocks(prims, atoms[ii], atoms[jj])
        # A molecule's own block is symmetric to rounding: make it exact.
        own = (ii == jj)[:, None, None]
        blk = torch.where(own, 0.5 * (blk + blk.transpose(1, 2)), blk)
        s[ii, :, jj, :] = blk
        s[jj, :, ii, :] = blk.transpose(1, 2)
    s = s.view(n, n)
    d = s.diagonal().rsqrt()
    # One factor d_i d_j an element, so S stays symmetric bit for bit.
    for lo in range(0, n, ROWS):
        s[lo:lo + ROWS].mul_(d[lo:lo + ROWS, None] * d[None, :])
    return s


def make_inputs(cfg: dict, pool: int, seed: int, device) -> list[Member]:
    """`pool` overlap matrices: S built densely on `device`, its nonzero
    leaf blocks kept, in float32."""
    b = cfg["block_size"]
    out = []
    for m in range(pool):
        s = overlap(cfg, seed, device, m)
        nb = s.shape[0] // b
        ids = counts.mask_ids((_norms2(s, nb) > 0).cpu().numpy())
        out.append(Member(s.shape[0], b, ids, common.blocks(s, ids, nb).to(torch.float32)))
        del s
    return out


def _orth_sq(z: torch.Tensor, s: torch.Tensor) -> float:
    """||Z S Z - I||_F^2 of dense matrices, in their dtype (float64 sums)."""
    zsz = (z @ s) @ z
    zsz.diagonal().sub_(1.0)
    return _sq_norm(zsz)


def reference(cfg: dict, m: Member, mode: str = "f64", steps: int | None = None,
              orth_each_step: bool = False) -> dict:
    """The reference Newton-Schulz iteration of `m` at `mode`'s precision,
    `steps` steps (the configuration's by default).  Returns Z's ids and
    blocks, each step's three pair counts and blocks held, its kept
    blocks, S dense in float64 for the check, and with `orth_each_step`
    ||Z_k S Z_k - I||_F / sqrt(n) of Z_0 .. Z_steps (at f64)."""
    a = cfg["assumed"]
    steps = a["n_steps"] if steps is None else steps
    nb, b, n = m.n // m.b, m.b, m.n
    dt = common.work_dtype(mode)
    tau2 = float(a["tau"]) ** 2
    s = common.dense(m.ids, m.data, nb, dt)
    theta = s.abs().sum(1).max()
    z = torch.eye(n, dtype=dt, device=s.device).div_(theta.sqrt())
    eye = np.eye(nb, dtype=bool)
    mask_s, mask_z = counts.block_mask(m.ids, nb), eye
    out = dict(pairs=[], held=[], kept=[], orth=[], theta=float(theta), nnz_s=int(mask_s.sum()))
    for k in range(steps + 1):
        zs = common.matmul(z, s, mode)
        t = common.matmul(zs, z, mode)
        del zs
        if orth_each_step:
            t.diagonal().sub_(1.0)
            out["orth"].append((_sq_norm(t) / n) ** 0.5)
            t.diagonal().add_(1.0)
        if k == steps:
            break
        t.mul_(-0.5).diagonal().add_(1.5)
        mask_zs = counts.product_mask(mask_z, mask_s)
        mask_t = counts.product_mask(mask_zs, mask_z) | eye
        mask_z2 = counts.product_mask(mask_z, mask_t)
        out["pairs"].append((counts.pairs(mask_z, mask_s), counts.pairs(mask_zs, mask_z),
                             counts.pairs(mask_z, mask_t)))
        out["held"].append(tuple(int(x.sum()) for x in (mask_z, mask_zs, mask_t, mask_z2)))
        z = common.matmul(z, t, mode)
        del t
        keep = _norms2(z, nb) > tau2
        z.view(nb, b, nb, b).mul_(keep.to(dt)[:, None, :, None])
        mask_z = keep.cpu().numpy()
        out["kept"].append(int(mask_z.sum()))
    ids = counts.mask_ids(mask_z)
    out.update(ids=ids, data=common.blocks(z, ids, nb), tau=float(a["tau"]), n=n, nb=nb,
               s=s.double() if mode == "f64" else None)
    return out


def work(cfg: dict, m: Member, ref: dict) -> dict:
    """FLOPs of the call's products, 2 b^3 times the three products' pairs
    of every step counted on the reference's own iterates, and its least
    bytes: each product reads its two operands' blocks once and writes
    its output's once (Z S, (Z S) Z into T, Z T)."""
    pairs = sum(sum(p) for p in ref["pairs"])
    blocks = sum((z + ref["nnz_s"] + zs) + (zs + z + t) + (z + t + z2)
                 for z, zs, t, z2 in ref["held"])
    return dict(pairs=pairs, flops=counts.gemm_flops(pairs, m.b),
                bytes=counts.block_bytes(blocks, m.b))


def answer(ref: dict) -> dict:
    """A reference result read as an answer of the program (the control)."""
    return dict(ids=ref["ids"], data=ref["data"], pairs=sum(sum(p) for p in ref["pairs"]),
                replans=0)


def compare(got: dict, ref: dict) -> dict:
    """The numbers `correct` is decided on, for one answer."""
    z_err, _ = common.compare_blocks(got["ids"], got["data"], ref["ids"], ref["data"])
    g_ids, r_ids = np.asarray(got["ids"], np.int64), np.asarray(ref["ids"], np.int64)
    orphan = 0.0
    for ids, data, other in ((g_ids, got["data"], r_ids), (r_ids, ref["data"], g_ids)):
        alone = torch.as_tensor(np.flatnonzero(~np.isin(ids, other)), device=data.device)
        if alone.numel():
            norms = data[alone].double().square().sum(dim=(1, 2)).sqrt()
            orphan = max(orphan, float(norms.max()) / ref["tau"])
    s = ref["s"]
    z = common.dense(g_ids, got["data"].to(s.device), ref["nb"], torch.float64)
    orth = (_orth_sq(z, s) / ref["n"]) ** 0.5
    del z
    pairs = sum(sum(p) for p in ref["pairs"])
    return dict(z_err=z_err, orphan_over_tau=orphan, orth_err=orth,
                pairs_rel_diff=abs(int(got["pairs"]) - pairs) / max(pairs, 1),
                replans=int(got["replans"]))
