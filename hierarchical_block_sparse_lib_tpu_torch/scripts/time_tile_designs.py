"""Time the 128-tile GEMM kernels of this checkout of the repository and of
others on one CUDA card, in turns: the others in order, this one twice, the
others in reverse.

    python hierarchical_block_sparse_lib_tpu_torch/scripts/time_tile_designs.py OTHER_ROOT...

Each OTHER_ROOT holds another checkout: the parent commit, unpacked with
``git archive``, or a copy of this one with a variant of a kernel's source
in place.  Each turn is a process of its own that imports the port from
one root and builds that root's kernels into that root's ``build/`` (the
turn machinery of scripts/time_micro_designs.py).  It makes
its inputs through that root's own functions: B3's step-0, step-1 and
step-2 inputs of `rows_spgemm` (bench.py's B3 input, `profile_purify`,
`plan_purify`, `purify_scan`) and B2-tile128's pair list of the pair-stream
kernel (`make_plan` on random_block_matrix(16384, 128, 0.05, seed=2)).  It
times `rows_spgemm` at each step at "highest", "high", "default" and with
bf16 data, the stream kernel at "highest" and "default", and
`groups_spgemm` at B1 (bench.py:700-721; `plan_groups`, its group tables
built once) at "highest", "high", "default" and with bf16 data: each as
the wrapper call (CUDA events, median of 7 after 2 warm-ups, ms) and as
the kernel's device time per launch (torch.profiler over 10 calls, µs).
Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))

N, STEPS, TAU = 4096, 5, 1e-6  # B3 (bench.py:356-443)


def device_us(fn, kernel: str, reps: int = 10) -> float:
    """Device µs per launch of the kernels whose names hold `kernel`, over
    `reps` calls of fn() under torch.profiler (0.0 if none was recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in p.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if kernel in e.key and dev > 0 and e.cpu_time_total == 0:
            total, count = total + dev, count + e.count
    return total / count if count else 0.0


def measure(root: str) -> dict:
    """name -> number, with the port imported from `root`."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import hierarchical_block_sparse_lib_tpu_torch as hbsm
    from hierarchical_block_sparse_lib_tpu_torch.core.block_matrix import run_slots
    from hierarchical_block_sparse_lib_tpu_torch.kernels import _build
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_groups as pg
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows as pr
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_stream as ps
    from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
    from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen
    from hierarchical_block_sparse_lib_tpu_torch.utils.generators import (
        banded_block_matrix,
        random_block_matrix,
    )
    from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import cuda_time_ms

    _build.load_all(["gemm_rows", "gemm_stream", "gemm_groups"])
    out = {}

    def timed(name, fn, kernel):
        out[f"{name}: call ms"] = cuda_time_ms(fn)[0]
        out[f"{name}: device us"] = device_us(fn, kernel)

    # B3's rows_spgemm inputs per step, as the scan makes them.
    a = banded_block_matrix(N, 256, 128)
    a = hbsm.add(a, hbsm.transpose(a), alpha=0.5, beta=0.5)
    a = hbsm.scale(a, 1.0 / float(np.sqrt(float(hbsm.frob_squared(a)))))
    a = hbsm.add(a, hbsm.eye(N, 128), beta=0.5, cap=a.cap + N // 128)
    prof = hbsm.profile_purify(a, STEPS, TAU, target_trace=N / 2)
    plans = hbsm.plan_purify(a, STEPS, TAU, prof, target_trace=N / 2)
    kw = dict(target_trace=N / 2, **prof.kwargs())
    for k in range(3):
        x = hbsm.repack(a, prof.cap) if k == 0 else hbsm.purify_scan(a, k, TAU, **kw)[0]
        args = (x.ids, x.data, x.ids, x.data, plans.step(k).out_ids, x.nb_rows, x.nb_rows,
                x.nb_cols, prof.out_cap, *prof.row_caps)
        bf = (x.ids, x.data.bfloat16(), x.ids, x.data.bfloat16()) + args[4:]
        for prec in ("highest", "high", "default"):
            timed(f"rows step {k} {prec}", lambda: pr.rows_spgemm(*args, precision=prec),
                  "rows_spgemm_kernel")
        timed(f"rows step {k} bf16", lambda: pr.rows_spgemm(*bf), "rows_spgemm_kernel")

    # B2-tile128's pair list through the stream kernel.
    b = random_block_matrix(16384, 128, 0.05, seed=2)
    pc, oc, _, _ = plan_spgemm_ex(b, b)
    plan = hbsm.make_plan(b, b, pc)
    seg = run_slots(plan.c_id, oc)[0].to(torch.int32)
    sargs = (b.data, b.data, plan.a_idx, plan.b_idx, seg, oc)
    for prec in ("highest", "default"):
        timed(f"stream B2-tile128 {prec}",
              lambda: ps.gather_gemm_accumulate_stream(*sargs, precision=prec), "stream_kernel")

    # B1 (bench.py:700-721) through the row-group kernel, its tables built
    # once as a planned call has them.
    n, bw = 4096, 64
    a16 = hbsm.from_coo(*gen.banded_coo(n, bw, seed=0), n, n, block_size=16)
    a, _ = hbsm.coarsen(a16, 8, cap=hbsm.plan_coarsen(a16, 8), track_leaves=True)
    gplan = hbsm.plan_groups(a, a)
    pc, oc, _, _ = plan_spgemm_ex(a, a)
    c, _ = hbsm.spgemm(a, a, pc, oc, backend="groups", group_caps=gplan.caps)
    tables = pg.group_tables(a.ids, a.ids, c.ids, a.nb_rows, a.nb_rows, a.nb_cols, gplan.g)
    gargs = (a.ids, a.data, a.ids, a.data, c.ids, a.nb_rows, a.nb_rows, a.nb_cols, oc,
             *gplan.caps)
    gbf = (a.ids, a.data.bfloat16(), a.ids, a.data.bfloat16()) + gargs[4:]
    for prec in ("highest", "high", "default"):
        timed(f"groups B1 {prec}",
              lambda: pg.groups_spgemm(*gargs, precision=prec, tables=tables), "groups_kernel")
    timed("groups B1 bf16", lambda: pg.groups_spgemm(*gbf, tables=tables), "groups_kernel")
    return out


def main(*other_roots: str) -> int:
    from hierarchical_block_sparse_lib_tpu_torch.scripts.time_micro_designs import run_turns

    return run_turns(__file__, list(other_roots))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, THIS_ROOT)
    sys.exit(main(*sys.argv[1:]))
