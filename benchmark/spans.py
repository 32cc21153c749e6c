"""The program's ``hbsm.`` spans in a traced window: ``torch.profiler``
events reduced to what each layer of the port costs a call.

The port opens a profiler range at each layer boundary
(``hierarchical_block_sparse_lib_tpu_torch/utils/profiling.py::span``):
entry spans around its public ops and the layer spans ``hbsm.host_plan``,
``hbsm.symbolic``, ``hbsm.product`` and ``hbsm.union`` inside them.  For
each span name this gives its calls, host seconds and self host seconds
(less its ``hbsm.`` children), the device seconds of the operations it
launched, and the host syncs made in it.

A device operation belongs to the innermost ``hbsm.`` span open on the
calling thread when its runtime call (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...) was made, matched by correlation id.  Glue is
device work launched in an entry span outside every layer span.  Device
work launched inside ``bench.call`` under no ``hbsm.`` span is
unattributed.  A host sync is a blocking runtime call (`SYNCS`) made
inside ``bench.call`` and outside ``bench.sync``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.trace import _is_device_op, _on_host

PREFIX = "hbsm."
CALL, SYNC = "bench.call", "bench.sync"
LAYERS = ("hbsm.host_plan", "hbsm.symbolic", "hbsm.product", "hbsm.union")
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))
RUNTIME = "cu"  # prefix of the host events of CUDA API calls


@dataclass
class SpanStats:
    calls: int = 0
    host_s: float = 0.0
    self_s: float = 0.0  # host seconds outside its hbsm. children
    device_s: float = 0.0  # device operations launched with it innermost
    syncs: int = 0


@dataclass
class SpanSummary:
    calls: int  # bench.call count
    spans: dict = field(default_factory=dict)  # name -> SpanStats
    call_device_s: float = 0.0  # device seconds launched inside bench.call
    unattributed_s: float = 0.0  # of which under no hbsm. span
    unattributed_syncs: int = 0

    def device_s(self, names) -> float:
        return sum(self.spans[n].device_s for n in names if n in self.spans)

    @property
    def glue_s(self) -> float:
        return self.device_s([n for n in self.spans if n not in LAYERS])

    @property
    def syncs(self) -> int:
        return self.unattributed_syncs + sum(s.syncs for s in self.spans.values())

    def values(self, least_s: float = 0.0) -> dict:
        """The layers' numbers per call (ms, syncs, %), from `least_s`, the
        calls' least time; the device's are None without a device
        timeline."""
        n = max(self.calls, 1)
        plan = self.spans.get("hbsm.host_plan")
        product = self.device_s(["hbsm.product"])
        dev = {
            "host_syncs_per_call": self.syncs / n,
            "symbolic_ms": self.device_s(["hbsm.symbolic"]) * 1e3 / n,
            "product_ms": product * 1e3 / n,
            "union_ms": self.device_s(["hbsm.union"]) * 1e3 / n,
            "glue_ms": self.glue_s * 1e3 / n,
            "call_device_ms": self.call_device_s * 1e3 / n,
            "unattributed_pct": 100.0 * self.unattributed_s / max(self.call_device_s, 1e-30),
            "fine_roofline_pct": 100.0 * least_s / product if product and least_s else None,
        }
        return {"host_plan_host_ms": plan.host_s * 1e3 / n if plan else None,
                **{k: v if self.call_device_s else None for k, v in dev.items()}}

    def table(self) -> str:
        """One line per span name: calls, host ms, self host ms, device ms
        and syncs per bench call; then the unattributed share."""
        n = max(self.calls, 1)
        lines = [f"{'span':<18}{'calls/call':>11}{'host ms':>10}{'self ms':>10}"
                 f"{'device ms':>11}{'syncs':>7}"]
        for name, s in sorted(self.spans.items(), key=lambda kv: -kv[1].device_s):
            lines.append(f"{name:<18}{s.calls / n:>11.2f}{s.host_s * 1e3 / n:>10.4f}"
                         f"{s.self_s * 1e3 / n:>10.4f}{s.device_s * 1e3 / n:>11.4f}"
                         f"{s.syncs / n:>7.2f}")
        share = 100.0 * self.unattributed_s / self.call_device_s if self.call_device_s else 0.0
        lines.append(f"device ms launched in {CALL} {self.call_device_s * 1e3 / n:.4f} a call, "
                     f"{share:.3f}% under no {PREFIX} span; syncs a call "
                     f"{self.syncs / n:.3f} ({self.unattributed_syncs / n:.3f} under none)")
        return "\n".join(lines)


def summarize(events, calls: int, window_span: str) -> SpanSummary:
    """Reduce kineto events to a SpanSummary over the host span
    `window_span` and its thread."""
    out = SpanSummary(calls=calls)
    win = [e for e in events if e.name() == window_span and _on_host(e)]
    if not win:
        return out
    w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    thread = win[0].start_thread_id()
    ranges, points, device = [], [], []
    for e in events:
        if _is_device_op(e):
            device.append((e.correlation_id(), e.duration_ns()))
        elif not (_on_host(e) and e.start_thread_id() == thread and w0 <= e.start_ns() <= w1):
            continue
        elif e.name().startswith(PREFIX) or e.name() in (CALL, SYNC):
            ranges.append((e.start_ns(), 0, -e.duration_ns(), e.name()))
        elif e.name().startswith(RUNTIME):
            points.append((e.start_ns(), 1, 0, e.name(), e.correlation_id()))
    launched = {}  # correlation id -> innermost hbsm. span or None
    stack = []  # open ranges: (end, name)
    for item in sorted(ranges + points):
        t = item[0]
        while stack and stack[-1][0] <= t:
            stack.pop()
        inner = next((n for _, n in reversed(stack) if n.startswith(PREFIX)), None)
        if item[1] == 0:
            dur, name = -item[2], item[3]
            if name.startswith(PREFIX):
                s = out.spans.setdefault(name, SpanStats())
                s.calls += 1
                s.host_s += dur * 1e-9
                s.self_s += dur * 1e-9
                if inner is not None:
                    out.spans[inner].self_s -= dur * 1e-9
            stack.append((t + dur, name))
            continue
        names = [n for _, n in stack]
        if CALL not in names:
            continue
        launched[item[4]] = inner
        if item[3] in SYNCS and SYNC not in names:
            if inner is None:
                out.unattributed_syncs += 1
            else:
                out.spans[inner].syncs += 1
    for corr, dur in device:
        if corr not in launched:
            continue
        inner = launched[corr]
        out.call_device_s += dur * 1e-9
        if inner is None:
            out.unattributed_s += dur * 1e-9
        else:
            out.spans[inner].device_s += dur * 1e-9
    return out
