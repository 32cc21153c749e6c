"""The column-slab tier (`ops/slab.py`) on the card at the near-dense
deployment's leaf and density (128, 50% blocks), cut to 4096^2: a
planned call makes no host sync, runs one `rows_spgemm` launch a slab,
counts its slabs, equals the tier's slab loop run by hand bit for bit,
and lies within the cell's `d_err` limit of the plain float64 reference
(`benchmark/reference/colslab.py`).

Needs a CUDA card (marker `card`; each test skips without one).  On a
machine with one, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_colslab_card.py

(`--noconftest`: the suite's conftest sets up the JAX package, which this
file does not use.)
"""

import os

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from benchmark import harness
from benchmark.reference import colslab as ref_colslab
from benchmark.systems.chain import matrix
from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows
from hierarchical_block_sparse_lib_tpu_torch.ops.slab import _colslab, plan_colslab
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import spgemm

pytestmark = pytest.mark.card

N, SLABS, SEED = 4096, 8, 2**31 + 2805
CONFIG = "benchmark/configs/b4_neardense32k_leaf128.json"


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the row-panel kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = harness.load_json(os.path.join(harness.ROOT, CONFIG))
    cfg["n"] = N
    m = ref_colslab.make_inputs(cfg, 1, SEED, "cuda")[0]
    a, b = matrix(m.a_ids, m.a_data, m.n, m.b), matrix(m.b_ids, m.b_data, m.n, m.b)
    plan = plan_colslab(a, b, SLABS)
    hbsm.spgemm_colslab(a, b, plan=plan)  # builds the kernel
    torch.cuda.synchronize()
    return cfg, m, a, b, plan


def test_planned_call_makes_no_host_sync(case):
    _, _, a, b, plan = case
    launches, slabs = pallas_gemm_rows.rows_spgemm.launches, hbsm.spgemm_colslab.slabs
    torch.cuda.set_sync_debug_mode("error")
    try:
        c, info = hbsm.spgemm_colslab(a, b, plan=plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert pallas_gemm_rows.rows_spgemm.launches - launches == len(plan.slabs) == SLABS
    assert hbsm.spgemm_colslab.slabs - slabs == SLABS
    assert int(info.n_block_pairs) == plan.total_pairs and int(c.nnz) == plan.n_out


def test_call_equals_the_slab_loop_and_the_reference(case):
    cfg, m, a, b, plan = case
    c, info = hbsm.spgemm_colslab(a, b, plan=plan, precision=cfg["precision"])
    want = torch.empty_like(c.data)
    for sl in plan.slabs:
        c_s, _ = spgemm(a, _colslab(b, sl), pair_cap=sl.pair_cap, out_cap=sl.out_cap,
                        precision=cfg["precision"], row_caps=sl.row_caps)
        want.index_copy_(0, torch.from_numpy(sl.pos).to(a.device).long(), c_s.data)
    assert torch.equal(c.data, want)
    ref = ref_colslab.reference(cfg, m, "f64")
    got = dict(ids=c.ids.cpu().numpy().astype(np.int64), data=c.data,
               pairs=int(info.n_block_pairs), out_blocks=int(info.n_out_blocks))
    numbers = ref_colslab.compare(got, ref)
    assert numbers["ids_diff"] == numbers["pairs_diff"] == numbers["out_diff"] == 0
    assert numbers["d_err"] <= cfg["limits"]["d_err"]
