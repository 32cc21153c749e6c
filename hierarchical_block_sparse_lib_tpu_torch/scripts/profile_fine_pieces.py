"""Split the planned B2 multiply into its parts, each timed alone on one
CUDA card: the counterpart of ``scripts/profile_fine_pieces.py``.

On the configured B2 (``random_block_matrix(16384, 32, 0.05, seed=2)``,
`fine_matmul(plan=)` at "highest", alpha 0.5):

  P1  the operand preparation, ``kernels/pallas_gemm_fine.py::_operands``
      (alpha folded into A^T; f32 payloads, contiguous);
  P2  the kernel's tables, ``fine_tables`` (made once by `make_fine_plan`,
      so not part of the planned call);
  P3  the kernel alone on the plan's tables and P1's operands;
  P4  the output pass ``_output``: a view for the flat layout the chain
      uses (part of the call), and the canonical transpose that
      `fine_unpack` pays (not part of it).

P1 + P3 + P4 (flat) should add up to the measured planned call; what is
left is the call's own glue (plan check, counters).  The script says
whether the sum falls within the spread of the measurements, and by how
much it misses if not.  Run on a CUDA card:

    python -m hierarchical_block_sparse_lib_tpu_torch.scripts.profile_fine_pieces

`main(device="cpu", n=512)` runs every part at a small size on the CPU,
P3 through the kernel's plain version (no time is measured there).
"""

from __future__ import annotations

import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine as pf
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.scripts.micro_fine_kernel import (
    fmt_ms,
    header,
    on_card,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.generators import random_block_matrix
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import card_time_ms, log


def main(device="cuda", n: int = 16384, leaf: int = 32, density: float = 0.05,
         seed: int = 2) -> dict:
    """Time the planned multiply and its parts; returns name -> (median
    ms, spread ms), both None off the card, plus "pairs" and "sum"."""
    card = header(device)
    A = random_block_matrix(n, leaf, density, seed=seed, device=device)
    pc, oc, mbr, mcr = plan_spgemm_ex(A, A)
    Af = hbsm.fine_pack(A)
    plan = hbsm.make_fine_plan(Af, Af, pc, oc, (mbr, mcr))
    nbr, nbc = Af.nb_rows, Af.nb_cols
    log(f"B2 parts: {n}^2 leaf {leaf} density {density} seed {seed}: {int(A.nnz)} blocks, "
        f"{pc} pairs, {oc} output blocks, row caps ({mbr}, {mcr})")
    _, _, prec, at, bt = pf._operands(Af.data, Af.data, leaf, "highest", 0.5)
    C, _ = hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan)
    ct = C.data.reshape(oc, leaf, leaf)
    if on_card(device):
        def kernel():
            return pf.launch(plan.out_ids, plan.tables, at, bt, oc, nbr, nbc, mbr, prec)

        if not torch.equal(kernel(), ct):
            raise AssertionError("the kernel alone differs from the planned call")
    else:  # no kernel off the card: the plain version on the same tables
        def kernel():
            return pf.fine_spgemm(Af.ids, Af.data, Af.ids, Af.data, plan.out_ids, nbr, nbr,
                                  nbc, oc, mbr, mcr, block_size=leaf, out_layout="flat",
                                  alpha=0.5, tables=plan.tables)
    parts = {
        "call": lambda: hbsm.fine_matmul(Af, Af, pc, oc, (mbr, mcr), alpha=0.5, plan=plan),
        "P1 operands": lambda: pf._operands(Af.data, Af.data, leaf, "highest", 0.5),
        "P2 fine_tables": lambda: pf.fine_tables(Af.ids, Af.ids, plan.out_ids, nbr, nbr,
                                                 nbc, leaf),
        "P3 kernel": kernel,
        "P4 output flat": lambda: pf._output(ct, leaf, "flat"),
        "P4 output canonical": lambda: pf._output(ct, leaf, "canonical"),
    }
    res = {"pairs": pc}
    for name, fn in parts.items():
        med, times = card_time_ms(fn, device)
        res[name] = (med, max(times) - min(times) if times else None)
        log(f"{name:22s}: {fmt_ms(med)}"
            + ("" if med is None else f" (spread {res[name][1]:.4f} ms over {len(times)})"))
    in_call = ("P1 operands", "P3 kernel", "P4 output flat")
    if res["call"][0] is not None:
        total = sum(res[k][0] for k in in_call)
        spread = res["call"][1] + sum(res[k][1] for k in in_call)
        gap = res["call"][0] - total
        res["sum"] = (total, spread)
        verdict = ("within the spread" if abs(gap) <= spread else
                   f"NOT within the spread: the call is {gap:+.4f} ms from the parts' sum")
        log(f"P1 + P3 + P4 flat = {total:.4f} ms against the call's {res['call'][0]:.4f} ms: "
            f"{verdict} ({spread:.4f} ms); the kernel alone is "
            f"{100 * res['P3 kernel'][0] / res['call'][0]:.1f}% of the call, "
            f"{res['P3 kernel'][0] / pc * 1e6:.2f} ns per pair")
    log(f"card: {card}")
    return res


if __name__ == "__main__":
    main()
