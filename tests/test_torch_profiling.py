"""The port's utils/profiling.py against the JAX package's: `Counters` fed
the `MultiplyInfo` and `PurificationStats` of the same operations in both
packages; the trace and timing helpers on the CPU; and the port's
scripts/profile_fine_pieces.py and time_fine_kernel.py at a small size."""

import json
import os

import numpy as np
import pytest
import torch

import hierarchical_block_sparse_lib_tpu as jx
import hierarchical_block_sparse_lib_tpu_torch as tx
from hierarchical_block_sparse_lib_tpu.models import purification as jpur
from hierarchical_block_sparse_lib_tpu.ops.spgemm import plan_spgemm
from hierarchical_block_sparse_lib_tpu.utils.profiling import Counters as JaxCounters
from hierarchical_block_sparse_lib_tpu_torch.scripts import profile_fine_pieces, time_fine_kernel
from hierarchical_block_sparse_lib_tpu_torch.utils import profiling as tp

from torch_port_helpers import matrix_pair

FIELDS = ("n_block_multiplies", "n_multiplies", "n_out_blocks", "overflows")


def counters(cls, infos):
    c = cls()
    for info in infos:
        c.record(info)
    return {f: getattr(c, f) for f in FIELDS}


def test_counters_match_jax_on_spgemm():
    """Three products, the last with caps too small (two overflow flags)."""
    ja, ta = matrix_pair(6, 5, 16, 0.4, 31, empty_rows=(2,), pad=2)
    jb, tb = matrix_pair(5, 7, 16, 0.4, 32)
    pc, oc = plan_spgemm(ja, jb)
    got, want = [], []
    for p, o in ((pc, oc), (pc + 4, oc + 3), (pc // 2, oc // 2)):
        got.append(tx.spgemm(ta, tb, p, o)[1])
        want.append(jx.spgemm(ja, jb, p, o, backend="xla")[1])
    assert counters(tp.Counters, got) == counters(JaxCounters, want)
    got = counters(tp.Counters, got)
    assert got["n_multiplies"] == 3 and got["n_block_multiplies"] >= 2 * pc
    assert got["overflows"] >= 1


def test_counters_match_jax_on_purification():
    """A 3-step purify_scan (stats stacked per step) and one sp2_step."""
    ja, ta = matrix_pair(8, 8, 16, 0.3, 33)
    ja = jx.add(jx.scale(jx.add(ja, jx.transpose(ja)), 0.02), jx.eye(128, 16), beta=0.5,
                cap=ja.cap + ja.cap + 8)
    ta = tx.add(tx.scale(tx.add(ta, tx.transpose(ta)), 0.02), tx.eye(128, 16, device="cpu"),
                beta=0.5, cap=ta.cap + ta.cap + 8)
    pc, oc = plan_spgemm(ja, ja)
    kw = dict(pair_cap=4 * pc, out_cap=64, target_trace=64.0, cap=64)
    _, js = jpur.purify_scan(ja, 3, 1e-3, backend="xla", **kw)
    _, ts = tx.purify_scan(ta, 3, 1e-3, **kw)
    _, js1 = jpur.sp2_step(ja, 1e-3, backend="xla", **kw)
    _, ts1 = tx.sp2_step(ta, 1e-3, **kw)
    got, want = counters(tp.Counters, [ts, ts1]), counters(JaxCounters, [js, js1])
    assert got == want
    assert got["n_multiplies"] == 4 and got["n_block_multiplies"] > 0


def test_counters_rates():
    c = tp.Counters()
    assert c.pairs_per_second() == 0.0 and c.effective_gflops(32) == 0.0
    with c.timed():
        pass
    c.n_block_multiplies, c.wall_s = 1000, 0.5
    assert c.pairs_per_second() == 2000.0
    assert c.effective_gflops(32) == pytest.approx(2 * 32**3 * 1000 / 0.5 / 1e9)


def test_device_trace_writes_a_trace(tmp_path):
    x = torch.ones(64, 64)
    with tp.device_trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert any("mm" in e.key for e in prof.key_averages())
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_timing_measures_nothing_off_the_card():
    assert tp.card_time_ms(lambda: None, "cpu") == (None, [])
    ms, by = tp.bound(67e9, 1.0)  # 1 ms of FP32 work, one byte
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = tp.bound(0.0, 3.35e9, "bf16")  # 1 ms of bytes
    assert (ms, by) == (pytest.approx(1.0), "bytes")


def test_bounds_name_the_tensor_core_route():
    """The 128-tile kernels' routes: TF32 at 495 TFLOP/s dense, a split
    tier's three passes at a third of its type's rate ("tf32x3" for
    "highest" on f32 data, "bf16x3" for "high").  B2-tile128 (5 156
    products of 128-wide blocks): 0.323 ms on FP32 FFMA, 0.131 ms on
    3xTF32."""
    assert tp.PEAK_OPS["tf32"] == 495e12
    assert tp.PEAK_OPS["tf32x3"] == pytest.approx(165e12)
    assert tp.PEAK_OPS["bf16x3"] == pytest.approx(989e12 / 3)
    flops = 2 * 128**3 * 5156
    assert tp.bound(flops, 0.0)[0] == pytest.approx(0.3228, abs=1e-4)
    ms, by = tp.bound(flops, 342.7e6, "tf32x3")  # operands and output: 0.102 ms of bytes
    assert (ms, by) == (pytest.approx(0.1311, abs=1e-4), "operations")


def test_profile_fine_pieces_runs_on_the_cpu():
    res = profile_fine_pieces.main("cpu", n=512)
    assert res["pairs"] > 0
    assert {"call", "P1 operands", "P2 fine_tables", "P3 kernel", "P4 output flat",
            "P4 output canonical"} <= set(res)
    assert all(v == (None, None) for k, v in res.items() if k != "pairs")


def test_time_fine_kernel_runs_on_the_cpu():
    res = time_fine_kernel.main("cpu", n=512)
    assert set(res) == {(b, t) for b in (16, 32, 64) for t in time_fine_kernel.TIERS}
    for r in res.values():  # counted, not timed
        assert r["pairs"] > 0 and r["ms"] is None and r["ns_per_product_per_sm"] is None
        assert r["bound"][0] > 0 and r["config"] == {}
