"""The column-slab tier (`ops/slab.py`) at the near-dense deployment's leaf
and density (128, 50% blocks), cut to 1024^2 and 2048^2 on the CPU: the
benchmark's generator and plain float64 reference
(`benchmark/reference/colslab.py`) against `spgemm_colslab(plan=)` at
float32 "highest", ids, pairs and output counts exactly, payloads within
the cell's `d_err` limit; the tier's span ``hbsm.colslab`` once a call
and its counter `spgemm_colslab.slabs`; and the output bit for bit that
of the tier's slab loop run by hand (each slab's `spgemm` and
`index_copy_`), with the profiler on and off."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hierarchical_block_sparse_lib_tpu_torch as hbsm
from benchmark import harness
from benchmark.reference import colslab as ref_colslab
from benchmark.systems.chain import matrix
from hierarchical_block_sparse_lib_tpu_torch.ops.slab import _colslab, plan_colslab
from hierarchical_block_sparse_lib_tpu_torch.ops.spgemm import spgemm

SEED = 2**31 + 2801
CONFIG = "benchmark/configs/b4_neardense32k_leaf128.json"


def config(n: int) -> dict:
    cfg = harness.load_json(os.path.join(harness.ROOT, CONFIG))
    cfg["n"] = n
    return cfg


def operands(n: int, seed: int = SEED):
    torch.set_num_threads(1)
    m = ref_colslab.make_inputs(config(n), 1, seed, "cpu")[0]
    return m, matrix(m.a_ids, m.a_data, m.n, m.b), matrix(m.b_ids, m.b_data, m.n, m.b)


@pytest.mark.parametrize("n_slabs", [4, 8])
@pytest.mark.parametrize("n", [1024, 2048])
def test_colslab_matches_the_reference(n, n_slabs):
    cfg = config(n)
    m, a, b = operands(n)
    assert m.b == 128 and m.a_ids.size == m.b_ids.size == (n // 128) ** 2 // 2
    plan = plan_colslab(a, b, n_slabs)
    c, info = hbsm.spgemm_colslab(a, b, plan=plan, precision=cfg["precision"])
    ref = ref_colslab.reference(cfg, m, "f64")
    nnz = int(c.nnz)
    assert nnz == ref["out_blocks"] == int(info.n_out_blocks) == plan.n_out
    np.testing.assert_array_equal(c.ids[:nnz].numpy().astype(np.int64), ref["ids"])
    assert int(info.n_block_pairs) == ref["pairs"] == plan.total_pairs
    assert not any(bool(f) for f in (info.pair_overflow, info.out_overflow, info.row_overflow,
                                     info.plan_mismatch))
    got = dict(ids=c.ids[:nnz].numpy(), data=c.data[:nnz], pairs=int(info.n_block_pairs),
               out_blocks=int(info.n_out_blocks))
    numbers = ref_colslab.compare(got, ref)
    assert numbers["ids_diff"] == numbers["pairs_diff"] == numbers["out_diff"] == 0
    assert numbers["d_err"] <= cfg["limits"]["d_err"]


def slab_loop(a, b, plan, precision):
    """The tier's arithmetic run by hand: each slab's `spgemm` on its
    gathered B columns, copied into the slab's output positions."""
    out = torch.empty((plan.n_out, a.block_size, a.block_size), dtype=a.dtype)
    for sl in plan.slabs:
        c_s, _ = spgemm(a, _colslab(b, sl), pair_cap=sl.pair_cap, out_cap=sl.out_cap,
                        precision=precision, row_caps=sl.row_caps)
        out.index_copy_(0, torch.from_numpy(sl.pos).long(), c_s.data)
    return out


def test_colslab_records_its_span_and_counts_its_slabs():
    _, a, b = operands(1024)
    plan = plan_colslab(a, b, 4)
    assert len(plan.slabs) == 4
    off, _ = hbsm.spgemm_colslab(a, b, plan=plan)
    before = hbsm.spgemm_colslab.slabs
    calls = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [hbsm.spgemm_colslab(a, b, plan=plan)[0] for _ in range(calls)]
    assert hbsm.spgemm_colslab.slabs - before == calls * len(plan.slabs)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("hbsm.colslab") == calls
    assert names.count("hbsm.spgemm") == calls * len(plan.slabs)
    want = slab_loop(a, b, plan, "highest")
    for c in [off] + outs:
        assert torch.equal(c.ids, torch.from_numpy(plan.out_ids))
        assert torch.equal(c.data, want)


def test_colslab_opens_no_range_without_a_profiler(monkeypatch):
    _, a, b = operands(1024)
    plan = plan_colslab(a, b, 4)
    want, _ = hbsm.spgemm_colslab(a, b, plan=plan)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got, _ = hbsm.spgemm_colslab(a, b, plan=plan)
    assert torch.equal(got.data, want.data)
