"""The traced window: ``torch.profiler`` events reduced to the device's
busy time, its operations by name, and its idle gaps by what the host
was doing.

The busy/idle arithmetic is a frozen copy of the port's
``utils/profiling.py::device_profile``: busy is the device time of the
operations recorded in the window, idle is the rest of the window timed
by CUDA events.  Here busy is the union of the operations' intervals,
which equals device_profile's sum on one stream and does not count two
streams' overlap twice.  A device operation is every kernel, copy and
memset on the device's timeline.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

HOST_SPAN = "bench."  # prefix of the benchmark's own record_function spans
TOP = 10


@dataclass
class TraceSummary:
    calls: int
    window_s: float  # CUDA events around the traced calls
    busy_s: float = 0.0  # union of device operations inside the window
    op_s: float = 0.0  # summed durations of those operations
    device_ops: int = 0
    op_seconds: dict = field(default_factory=dict)  # name -> seconds
    idle_seconds: dict = field(default_factory=dict)  # host activity -> seconds

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.op_seconds), "idle_gaps": top(self.idle_seconds)}


def _on_host(e) -> bool:
    return str(e.device_type()).endswith("CPU")


def _is_device_op(e) -> bool:
    """A kernel, copy or memset on the device's timeline; the device-side
    copies of record_function spans are none of these."""
    if _on_host(e) or e.name().startswith(HOST_SPAN):
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation and annotation())


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def label_gaps(gaps, host):
    """Seconds of device idleness by the host activity at each gap's
    midpoint: the innermost benchmark span and, inside it, the innermost
    host event (a PyTorch operator or a runtime call), or "python" when
    the span itself is innermost.  `host` is (start, end, name) of one
    thread's properly nested events; times in ns."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out = defaultdict(float)
    stack, j = [], 0
    for g0, g1 in sorted(gaps):
        q = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= q:
            while stack and stack[-1][1] <= host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= q:
            stack.pop()
        spans = [h[2] for h in stack if h[2].startswith(HOST_SPAN)]
        span = spans[-1] if spans else "outside"
        inner = stack[-1][2] if stack and not stack[-1][2].startswith(HOST_SPAN) else "python"
        out[f"{span}/{inner}"] += (g1 - g0) * 1e-9
    return dict(out)


def summarize(events, calls: int, window_s: float, window_span: str) -> TraceSummary:
    """Reduce kineto events to a TraceSummary.  The window's bounds on the
    profiler's clock are those of the host span `window_span`."""
    ts = TraceSummary(calls=calls, window_s=window_s)
    win = [e for e in events if e.name() == window_span and _on_host(e)]
    if not win:
        return ts
    w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    thread = win[0].start_thread_id()
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if _is_device_op(e):
            s, t = max(s, w0), min(s + d, w1)
            if t > s:
                dev.append((s, t))
                ts.device_ops += 1
                ts.op_s += (t - s) * 1e-9
                ts.op_seconds[e.name()] = ts.op_seconds.get(e.name(), 0.0) + (t - s) * 1e-9
        elif _on_host(e) and e.start_thread_id() == thread:
            host.append((s, s + d, e.name()))
    busy = merge(dev)
    ts.busy_s = sum(t - s for s, t in busy) * 1e-9
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if w1 > at:
        gaps.append((at, w1))
    ts.idle_seconds = label_gaps(gaps, host)
    return ts
