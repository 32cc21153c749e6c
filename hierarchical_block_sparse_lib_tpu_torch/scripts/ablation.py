"""The measurement protocol of the port's ablation scripts: the
counterparts of ``scripts/profile_b3.py``, ``profile_scan.py``,
``bench_symmetric.py``, ``profile_routed_1dev.py``,
``bench_scatter_accum.py``, ``bench_band_route.py``,
``bench_planner_scaling.py`` and ``b5_route2_evidence.py``.

The JAX scripts timed each part with bench.py's chained `fori_loop`
differential, which exists only because of the TPU's remote backend
(cached results, a `block_until_ready` that did not block).  Here each
part is a callable, and `Run.measure` gives it four numbers on the card:

- its call time, CUDA events around each call, measured in turns with
  the parts it is compared with (in order, then in reverse order;
  `bench.time_in_turns`): the median of the two turns' medians, and the
  min and max over every sample;
- its device time and device launches per call, from ``torch.profiler``
  (`utils/profiling.py::device_profile`);
- the launches of the port's kernels per call, read from the wrappers'
  ``.launches`` counters.

The differences the JAX scripts print ("symbolic + union = accum - plan")
subtract host-bound calls, which spread about 2x between runs, so
`Run.difference` gives each one with the spread of its terms (the sum of
each term's max - min), says when it lies inside that spread (then it is
no measured cost), and gives the same difference in device time, by
which the scripts attribute.

Off the card a script computes every structure, counter and result and
measures no time: each time is None.  `Run.finish` prints the script's
last stdout line, one JSON object with its counters, checks, parts,
differences, the port's kernel launches over the whole run, its wall
seconds and the peak device memory.
"""

from __future__ import annotations

import json
import time

import torch

from hierarchical_block_sparse_lib_tpu_torch.bench import (
    launch_counts,
    launched_by,
    launches_since,
    time_in_turns,
)
from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import (
    card_line,
    device_profile,
    log,
    per_call_us,
)


def resolve(device):
    """The device a script runs on: the card unless `device` names
    another; None when there is no card (the script then exits 2)."""
    if device is None and not torch.cuda.is_available():
        return None
    return torch.device("cuda" if device is None else device)


def fmt(rec) -> str:
    if rec is None or rec.get("ms") is None:
        return "not measured (no card)"
    dev = "not measured" if rec["device_ms"] is None else f"{rec['device_ms']:.3f} ms"
    return (f"{rec['ms']:.3f} ms [min {rec['min']:.3f}, max {rec['max']:.3f}], device {dev}, "
            f"{rec['launches']} launches")


class Run:
    """One script's run: its device, counters, checks, measured parts and
    differences, printed by `finish` as its last stdout line."""

    def __init__(self, script: str, device: torch.device):
        self.script, self.device = script, device
        self.on_card = device.type == "cuda"
        self.card = card_line() if self.on_card else f"{device}: no card, times not measured"
        self.counters, self.checks, self.parts, self.derived = {}, {}, {}, {}
        self.t0, self.before = time.perf_counter(), launch_counts()
        if self.on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        log(f"{script}: torch {torch.__version__} cuda {torch.version.cuda}; {self.card}")

    def check(self, name: str, ok: bool, detail="") -> None:
        """Record a check; a failed one raises (the script exits non-zero)."""
        self.checks[name] = bool(ok)
        log(f"check {name}: {'ok' if ok else 'FAILED'} {detail}")
        if not ok:
            raise AssertionError(f"{self.script}: {name} failed {detail}")

    def measure(self, calls: dict, reps: int = 10, warmup: int = 2, timing_reps: int = 7) -> dict:
        """Measure each part of `calls` (name -> callable); the parts of
        one call are timed in turns with each other (`timing_reps` events
        a turn after `warmup` calls), then profiled over `reps` calls."""
        kernels = {name: launched_by(fn)[1] for name, fn in calls.items()}
        times = time_in_turns(calls, self.device, warmup, timing_reps)
        for name, fn in calls.items():
            rec = dict(ms=None, min=None, max=None, device_ms=None, launches=None,
                       kernels=kernels[name])
            t = times[name]
            if t is not None:
                dev = device_profile(f"{self.script}: {name}", fn, reps, self.card, top=5)
                rec.update(ms=t["ms"], min=min(x[1] for x in t["turns"]),
                           max=max(x[2] for x in t["turns"]),
                           device_ms=per_call_us(dev, reps) / 1e3 if dev else None,
                           launches=sum(c for _, c in dev.values()) / reps if dev else None)
            self.parts[name] = rec
            log(f"  {name:28s} {fmt(rec)}; port kernels per call {kernels[name]}")
        return self.parts

    def difference(self, name: str, plus, minus=(), scale: float = 1.0):
        """scale * (sum of `plus` - sum of `minus`) in call time and in
        device time, with the spread of its terms."""
        terms = [self.parts[k] for k in (*plus, *minus)]
        if not self.on_card:
            self.derived[name] = None
            return None
        ms = scale * (sum(self.parts[k]["ms"] for k in plus)
                      - sum(self.parts[k]["ms"] for k in minus))
        spread = scale * sum(t["max"] - t["min"] for t in terms)
        dev = None
        if all(t["device_ms"] is not None for t in terms):
            dev = scale * (sum(self.parts[k]["device_ms"] for k in plus)
                           - sum(self.parts[k]["device_ms"] for k in minus))
        # A part scaled alone (a scan per step) is a value, not a difference.
        within = abs(ms) <= spread if minus else None
        self.derived[name] = dict(ms=ms, spread=spread, within_spread=within, device_ms=dev)
        log(f"{name:32s} call {ms:+.3f} ms, spread of its terms {spread:.3f} ms"
            + {True: ": inside the spread, not a measured cost", False: ": outside the spread",
               None: ""}[within]
            + ("" if dev is None else f"; device {dev:+.3f} ms"))
        return self.derived[name]

    def finish(self, **extra) -> int:
        """Print the last line and return the exit code 0."""
        if self.on_card:
            torch.cuda.synchronize(self.device)
        rec = dict(script=self.script, device=self.card, counters=self.counters,
                   checks=self.checks, parts=self.parts, derived=self.derived, **extra,
                   launches=launches_since(self.before),
                   wall_s=time.perf_counter() - self.t0,
                   peak_gib=(torch.cuda.max_memory_allocated(self.device) / 2**30
                             if self.on_card else None))
        print(json.dumps(rec), flush=True)
        return 0
