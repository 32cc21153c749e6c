"""The port's counterpart of the repository's ``__graft_entry__.entry``: one
purification-style iteration (SpGEMM C = X*X, the SP2 blend and a norm
truncation) on a banded 1024^2 matrix with 128-wide blocks, the step
`chip_smoke.py` runs first on the card."""

from __future__ import annotations

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from hierarchical_block_sparse_lib_tpu_torch.models.purification import sp2_step
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import plan_spgemm_ex
from hierarchical_block_sparse_lib_tpu_torch.utils import generators as gen


def entry(device=None):
    """(fn, (x,)): fn(x) is one SP2 step, (X', PurificationStats), on the
    input the JAX package's entry builds (1024^2, band 48, 16-blocks
    coarsened to 128, scaled by 0.01, plus I/2), on the card unless
    `device` names another."""
    n, bw = 1024, 48
    rows, cols, vals = gen.banded_coo(n, bw, seed=0)
    x = hbsm.from_coo(rows, cols, vals, n, block_size=16, device=device)
    x = hbsm.coarsen(x, 8)  # 128-blocks
    x = hbsm.scale(x, 0.01)
    x = hbsm.add(x, hbsm.eye(n, 128, device=x.device), beta=0.5, cap=x.cap + n // 128)
    pc, oc, mbr, mcr = plan_spgemm_ex(x, x)
    nb = n // 128

    def fn(x):
        return sp2_step(
            x, tau=1e-7, pair_cap=2 * pc, out_cap=2 * oc, target_trace=n / 2,
            row_caps=(min(nb, 2 * mbr), min(nb, 2 * mcr)),
        )

    return fn, (x,)
