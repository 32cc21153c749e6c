"""The routed product on a one-shard mesh, in parts, on one CUDA card: the
counterpart of ``scripts/profile_routed_1dev.py``.

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.profile_routed_1dev

Input: B2-tile128, ``random_block_matrix(16384, 128, 0.05, seed=2)``, at
"highest".  Parts, measured in turns (`scripts/ablation.py`):

  local           the planned local `spgemm` (the bench's baseline)
  local+accum     the same product through the fused accumulate, into an
                  empty accumulator at the union capacity
  pack            the stage's panel gather alone (`route.pack`)
  routed          the frozen `dist_spgemm_routed` on `dist.make_mesh(1)`
  local(chainD)   the control: the local product with A's payload read
                  from the head of a union-sized buffer, as the next two
  stage+aligned   a later routed stage's accumulate: the product into a
                  non-empty accumulator D on the product's support, in the
                  row-panel kernel (`accum_aligned`, `acc_data`)
  stage+generic   the same through the generic union gather-add, which the
                  JAX script could not time (an XLA:TPU compiler crash)

Differences: each accumulate over its baseline, the pack, and the routed
call's overhead over local.  Checks: B2-tile128's counters as the JAX
package plans them (819 blocks, 5 156 pairs, 4 415 output blocks), every
flag clean, the send panel (all of the shard's blocks, passed through on
one shard), and the aligned and generic accumulates within 1e-5 of each
other.

`main(device="cpu", n=2048, density=0.2)` runs every part at a small size
on the CPU, where no time is measured.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.bench import check_info, rel_err
from hierarchical_block_sparse_lib_tpu_torch.core import assembly
from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import SENTINEL
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.parallel import dist, route
from hierarchical_block_sparse_lib_tpu_torch.scripts.ablation import Run, resolve
from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import log

PRECISION = "highest"
TOL = 1e-5
# B2-tile128's (blocks, pairs, output blocks) as the JAX package plans
# them, keyed by (n, density).
EXPECTED = {(16384, 0.05): (819, 5156, 4415)}


def setup(n: int, density: float, device):
    """A, its host plan, the one-shard routed plan (plain and frozen) and
    the accumulator D: the product's support with N(0, 1) blocks from
    seed 7."""
    A = gen.random_block_matrix(n, 128, density, seed=2, device=device)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    mesh1 = dist.make_mesh(1, device=device)
    Ad = dist.distribute(A, mesh1)
    rplan = route.plan_route(Ad, Ad, 1)
    frozen = route.freeze_route_plan(Ad, Ad, rplan)
    C0, _ = hbsm.spgemm(A, A, pc, oc, row_caps=(mbr, mcr), precision=PRECISION)
    rng = np.random.default_rng(7)
    noise = torch.from_numpy(rng.standard_normal((oc, 128, 128)).astype(np.float32))
    D = C0.with_data(torch.where(C0.valid_mask()[:, None, None], noise.to(A.device), 0.0))
    return A, (pc, oc, mbr, mcr), mesh1, Ad, rplan, frozen, D


def main(argv=None, device=None, n: int = 16384, density: float = 0.05) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve(device)
    if dev is None:
        log("profile_routed_1dev: no CUDA device; nothing to run")
        return 2
    run = Run("profile_routed_1dev", dev)
    A, (pc, oc, mbr, mcr), mesh1, Ad, rplan, frozen, D = setup(n, density, dev)
    sidx = rplan.send_idx[0][0]
    panel = int((sidx >= 0).sum())
    passthrough = bool((sidx == np.arange(len(sidx))).all())
    run.counters.update(blocks=int(A.nnz), pairs=pc, out=oc, row_caps=[mbr, mcr],
                        send_panel=panel, passthrough=passthrough, stages=list(rplan.stages),
                        aligned=frozen.aligned)
    log(f"B2-tile128 {n}^2 at {density:.0%}: blocks={int(A.nnz)} pairs={pc} out={oc}; send panel: "
        f"{panel} of {int(A.nnz)} blocks (passthrough={passthrough})")
    want = EXPECTED.get((n, density))
    if want is not None:
        got = (int(A.nnz), pc, oc)
        run.check("counters equal to the JAX package's", got == want, f"{got} vs {want}")
    run.check("send panel is the shard's every block, passed through",
              panel == int(A.nnz) and passthrough)

    kw = dict(row_caps=(mbr, mcr), precision=PRECISION)
    plan_l = hbsm.make_plan(A, A, pc)
    acc_ids = torch.full((oc,), SENTINEL, dtype=torch.int32, device=dev)
    plan_a = hbsm.make_plan(A, A, pc, accum_ids=acc_ids, out_cap=oc)
    acc0 = assembly.empty(A.n_rows, A.n_cols, A.block_size, oc, dtype=A.dtype, device=dev)
    plan_u = hbsm.make_plan(A, A, pc, accum_ids=D.ids, out_cap=oc)
    # A's payload read from the head of the union-sized buffer, as the
    # JAX script's chain does it (same shapes, other values).
    Ac = A.with_data(D.data[: A.cap])
    width = rplan.send_idx[0].shape[1]
    calls = {
        "local": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan_l, **kw),
        "local+accum": lambda: hbsm.spgemm(A, A, pc, oc, plan=plan_a, accum=acc0, beta=1.0, **kw),
        "pack": lambda: route.pack(Ad.shards, frozen.send[0], width),
        "routed": lambda: route.dist_spgemm_routed(Ad, Ad, mesh1, frozen, precision=PRECISION),
        "local(chainD)": lambda: hbsm.spgemm(Ac, Ac, pc, oc, plan=plan_l, **kw),
        "stage+aligned": lambda: hbsm.spgemm(Ac, Ac, pc, oc, plan=plan_u, accum=D,
                                             accum_aligned=True, **kw),
        "stage+generic": lambda: hbsm.spgemm(Ac, Ac, pc, oc, plan=plan_u, accum=D, **kw),
    }
    results = {}
    for key in ("local", "local+accum", "local(chainD)", "stage+aligned", "stage+generic"):
        results[key], info = calls[key]()
        check_info(f"B2-tile128 {key}", info, pc, oc)
    run.checks["local flags clean and counters as planned"] = True
    _, st = calls["routed"]()
    run.check("routed flags clean",
              not bool(st["plan_mismatch"]) and not bool(st["overflow"])
              and int(st["n_block_pairs"]) == pc)
    err = rel_err(results["stage+aligned"].data, results["stage+generic"].data)
    run.counters["aligned_vs_generic"] = err
    run.check(f"aligned and generic accumulates within {TOL}",
              torch.equal(results["stage+aligned"].ids, results["stage+generic"].ids)
              and err <= TOL, f"{err:.3e}")
    err = rel_err(results["local+accum"].data, results["local"].data)
    run.check(f"empty accumulate within {TOL} of local", err <= TOL, f"{err:.3e}")
    del results

    run.measure(calls)
    run.difference("gather-add, empty accumulator (local+accum - local)", ["local+accum"],
                   ["local"])
    run.difference("gather-add, later stage (stage+generic - local(chainD))", ["stage+generic"],
                   ["local(chainD)"])
    run.difference("aligned accumulate (stage+aligned - local(chainD))", ["stage+aligned"],
                   ["local(chainD)"])
    run.difference("chain harness (local(chainD) - local)", ["local(chainD)"], ["local"])
    run.difference("routed overhead (routed - local)", ["routed"], ["local"])
    t = run.parts
    if t["local"]["ms"] is not None:
        for k, v in t.items():
            log(f"{k:14s}: {v['ms']:7.3f} ms ({v['ms'] / t['local']['ms']:.2f}x local)")
    return run.finish()


if __name__ == "__main__":
    sys.exit(main())
