"""The span summary (``spans.py``) on synthetic event lists and on CPU
traced runs of each cell; the existing trace summary and its readers
unmoved by the program's spans; ``host_plan_ms`` read from the idle gap
the host plan's span names."""

import pytest

from bench_small import WORKLOADS, small_cell
from benchmark import harness, spans, trace
from benchmark.tools.span_table import traced_run

MS = 1_000_000  # ns
THREAD = 7


class Ev:
    """A kineto event as the summaries read it."""

    def __init__(self, name, start_ms, dur_ms, device="CPU", corr=0, kind="cpu_op",
                 thread=THREAD):
        self._n, self._s, self._d = name, int(start_ms * MS), int(dur_ms * MS)
        self._dev, self._corr, self._kind, self._thread = device, corr, kind, thread

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def span(name, start, dur):
    return Ev(name, start, dur, kind="user_annotation")


def launch(start, corr, name="cudaLaunchKernel"):
    return Ev(name, start, 0.01, corr=corr, kind="cuda_runtime")


def kernel(name, start, dur, corr):
    return Ev(name, start, dur, device="CUDA", corr=corr, kind="kernel")


def call(t, c, with_spans=True):
    """One chain call at t ms: a planned product with its mismatch check,
    the add with its union and glue, the scale, a host read of an id
    (memcpy and sync) in the product span, then the benchmark's sync.
    Correlation ids from `c` on."""
    ev = [span("bench.call", t, 9), launch(t + 0.1, c + 100)]
    ev += [kernel("mismatch_any", t + 0.2, 0.1, c + 100)]
    if with_spans:
        ev += [span("hbsm.fine_matmul", t + 0.05, 3), span("hbsm.product", t + 0.5, 2),
               span("hbsm.add", t + 3.5, 4), span("hbsm.union", t + 4, 2),
               span("hbsm.scale", t + 7.6, 1)]
    ev += [launch(t + 0.6, c + 200), kernel("fine_spgemm_kernel", t + 0.7, 1.0, c + 200),
           launch(t + 1.9, c + 210, "cudaMemcpyAsync"),
           launch(t + 1.95, c + 211, "cudaStreamSynchronize"),
           kernel("Memcpy DtoH", t + 1.92, 0.02, c + 210),
           launch(t + 3.6, c + 300), kernel("cat", t + 3.7, 0.3, c + 300),
           launch(t + 4.1, c + 310), kernel("index_add", t + 4.2, 1.0, c + 310),
           launch(t + 7.7, c + 400), kernel("mul", t + 7.8, 0.5, c + 400),
           span("bench.sync", t + 9, 0.5), launch(t + 9.1, c + 500, "cudaDeviceSynchronize")]
    if with_spans:  # the device-side copies of the spans
        ev += [Ev("hbsm.product", t + 0.7, 1.0, device="CUDA", kind="gpu_user_annotation"),
               Ev("hbsm.union", t + 4.2, 1.0, device="CUDA", kind="gpu_user_annotation")]
    return ev


def window(with_spans=True, calls=2, stray=True):
    ev = [span("bench.window", 0, 10 * calls + 1)]
    for i in range(calls):
        ev += call(10 * i + 0.5, 1000 * (i + 1), with_spans)
    if stray:  # launched outside bench.call and on another thread: not attributed
        ev += [launch(9.7, 900), kernel("flag_fold", 9.75, 0.1, 900),
               Ev("cudaLaunchKernel", 1.0, 0.01, corr=901, kind="cuda_runtime", thread=8),
               kernel("other_thread", 1.1, 0.2, 901)]
    return ev


def test_innermost_attribution_by_correlation_id():
    s = spans.summarize(window(), 2, "bench.window")
    ms = {k: v.device_s * 1e3 / 2 for k, v in s.spans.items()}
    assert ms == pytest.approx({"hbsm.fine_matmul": 0.1, "hbsm.product": 1.02,
                                "hbsm.add": 0.3, "hbsm.union": 1.0, "hbsm.scale": 0.5})
    assert s.call_device_s * 1e3 / 2 == pytest.approx(2.92)
    assert s.glue_s * 1e3 / 2 == pytest.approx(0.9)
    v = s.values(least_s=2 * 0.51e-3)
    assert v["product_ms"] == pytest.approx(1.02) and v["union_ms"] == pytest.approx(1.0)
    assert v["fine_roofline_pct"] == pytest.approx(50.0)
    assert v["symbolic_ms"] == 0.0 and v["host_plan_host_ms"] is None


def test_nested_self_time():
    s = spans.summarize(window(), 2, "bench.window")
    st = s.spans
    assert st["hbsm.fine_matmul"].calls == 2
    assert st["hbsm.fine_matmul"].host_s == pytest.approx(6e-3)
    assert st["hbsm.fine_matmul"].self_s == pytest.approx(2e-3)  # 3 ms less the product's 2
    assert st["hbsm.add"].self_s == pytest.approx(4e-3)
    assert st["hbsm.union"].self_s == st["hbsm.union"].host_s == pytest.approx(4e-3)


def test_syncs_counted_inside_the_call_not_in_its_sync():
    s = spans.summarize(window(), 2, "bench.window")
    assert s.spans["hbsm.product"].syncs == 2
    assert s.syncs == 2 and s.unattributed_syncs == 0
    assert s.values()["host_syncs_per_call"] == 1.0


def test_unattributed_share():
    s = spans.summarize(window(with_spans=False), 2, "bench.window")
    assert s.spans == {}
    assert s.unattributed_s == pytest.approx(s.call_device_s) and s.call_device_s > 0
    assert s.values()["unattributed_pct"] == pytest.approx(100.0)
    assert s.unattributed_syncs == 2
    assert spans.summarize(window(), 2, "bench.window").values()["unattributed_pct"] == 0.0
    assert "0.000% under no hbsm. span" in spans.summarize(window(), 2, "bench.window").table()


def test_no_window_no_summary():
    s = spans.summarize(window()[1:], 2, "bench.window")
    assert s.spans == {} and s.call_device_s == 0 and s.values()["call_device_ms"] is None


@pytest.mark.parametrize("metric", ["launches_per_call", "kernel_roofline_pct", "device_idle_pct"])
def test_program_spans_move_no_existing_reading(metric):
    """The trace summary's device numbers, and the readers of the
    accepted per-layer metrics, read the same with the program's spans
    (host ranges and their device-side copies) as without them."""
    got = {}
    for with_spans in (False, True):
        t = trace.summarize(window(with_spans), 2, 21e-3, "bench.window")
        run = harness.Run(calls=2, trace=t, least_s=1e-3)
        got[with_spans] = (t.device_ops, t.op_s, t.busy_s, t.op_seconds,
                           harness.load_reader(metric).read(run))
    assert got[True] == got[False]
    # 5 kernels and a copy a call and the 2 strays: no annotation counted.
    assert got[True][0] == 14


def test_host_plan_ms_reads_the_span_gap():
    t = trace.summarize(window(), 2, 21e-3, "bench.window")
    read = harness.load_reader("host_plan_ms").read
    assert read(harness.Run(calls=2, trace=t)) is None  # no host plan in the window
    t.idle_seconds[read.__globals__["GAP"]] = 0.04
    assert read(harness.Run(calls=2, trace=t)) == pytest.approx(20.0)
    t.device_ops = 0  # no device timeline: nothing to read
    assert read(harness.Run(calls=2, trace=t)) is None


EXPECTED = {
    "b2_chain.planned": {"hbsm.fine_matmul", "hbsm.product", "hbsm.add", "hbsm.union",
                         "hbsm.scale"},
    "b2_chain.oneoff": {"hbsm.matmul", "hbsm.host_plan", "hbsm.spgemm", "hbsm.symbolic",
                        "hbsm.product", "hbsm.add", "hbsm.union", "hbsm.scale"},
}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_cpu_run_names_the_cells_spans(workload):
    import time

    import torch

    torch.set_num_threads(1)
    r, s, run = traced_run(small_cell(workload), 2**31 + 5, 0.2, "cpu", time.perf_counter())
    assert r["correct"] and r["metrics"] == {}
    assert set(s.spans) == EXPECTED[workload]
    assert all(v.calls == s.calls for k, v in s.spans.items() if k != "hbsm.host_plan")
    assert s.call_device_s == 0 and run.trace is not None
    # The harness is left as it was.
    assert trace.summarize.__module__ == "benchmark.trace" and harness.Run is type(run).__mro__[1]
