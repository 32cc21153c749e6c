"""Operation counters, device traces and the port's timing protocol.

The counterpart of ``hierarchical_block_sparse_lib_tpu/utils/profiling.py``.
`Counters` aggregates the exact operation counters of `MultiplyInfo` and
`PurificationStats` over a sequence of operations, as the reference's
out-params do; `device_trace` records a ``torch.profiler`` trace.

Timing.  The JAX package timed the TPU with a chained differential
(bench.py's `bench_chained`) because that backend served cached results
and its `block_until_ready` did not block.  CUDA has neither quirk, so
the port's protocol is plainer: CUDA events around each call, warm-up
calls first, the median of n (`cuda_time_ms`); two callables compared in
turns, plain, kernel, kernel, plain (`alternate`), or several measured in
order and then in reverse order (`in_turns`), so that a drift of the
card's clock or of the host falls on both sides.  Times exist only on the
card: `card_time_ms` measures nothing on another device and says so.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch


# NVIDIA H100 SXM data sheet at 700 W, dense: operations per second by
# type (FP32 outside the tensor cores; TF32 and bf16 on them) and HBM3
# bytes per second.  The least time a function can take on the card is
# the larger of its operations over the peak for their type and its bytes
# (each input read once, each output written once) over the memory rate.
# A split tier's product takes three tensor-core passes, so its rate per
# product operation is a third of its type's: "tf32x3" for 3xTF32 (the
# 128-tile kernels' "highest" on f32 data), "bf16x3" for the bf16 split
# ("high").
PEAK_OPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12,
            "tf32x3": 495e12 / 3, "bf16x3": 989e12 / 3}
HBM_BYTES = 3.35e12


def bound(ops: float, nbytes: float, kind: str = "fp32"):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], nbytes / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def log(*args) -> None:
    """Print to stderr, flushed (the scripts' progress lines)."""
    print(*args, file=sys.stderr, flush=True)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass
class Counters:
    """Accumulates the reference's counters over a sequence of ops.

    Feed each op's `MultiplyInfo` / `PurificationStats` via `record`;
    all fields are exact (mirroring the reference's out-params, not
    sampled estimates).
    """

    n_block_multiplies: int = 0  # reference: no_of_block_multiplies
    n_multiplies: int = 0  # SpGEMM invocations
    n_out_blocks: int = 0  # distinct output blocks produced
    overflows: int = 0  # any capacity overflow observed
    wall_s: float = 0.0  # host wall time inside `timed` sections

    def record(self, info) -> None:
        """Accumulate a MultiplyInfo or PurificationStats (or any object
        with n_block_pairs / overflow fields; tensors are read to the
        host, which waits for the device)."""
        pairs = getattr(info, "n_block_pairs", None)
        if pairs is not None:
            arr = _host(pairs)
            self.n_block_multiplies += int(arr.sum())
            self.n_multiplies += max(int(arr.size), 1)
        outs = getattr(info, "n_out_blocks", None)
        if outs is not None:
            self.n_out_blocks += int(_host(outs).sum())
        for f in (
            "pair_overflow", "out_overflow", "row_overflow",
            "repack_overflow", "plan_mismatch",
        ):
            v = getattr(info, f, None)
            if v is not None and bool(_host(v).any()):
                self.overflows += 1

    @contextlib.contextmanager
    def timed(self):
        """Accumulate host wall time; the caller must wait for the device
        inside the section (torch.cuda.synchronize, or reading a result)
        for device work to be attributed."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.wall_s += time.perf_counter() - t0

    def pairs_per_second(self) -> float:
        return self.n_block_multiplies / self.wall_s if self.wall_s else 0.0

    def effective_gflops(self, block_size: int) -> float:
        """2*b^3 FLOPs per recorded block multiply (BASELINE.json:2)."""
        return (
            2 * block_size**3 * self.n_block_multiplies / self.wall_s / 1e9
            if self.wall_s
            else 0.0
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the section (CPU, and CUDA where there is
    a card), written as ``<log_dir>/trace.json`` for chrome://tracing or
    Perfetto.  Yields the profiler, whose `key_averages()` sum the time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=2, reps=7):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), times


def card_time_ms(fn, device, warmup=2, reps=7):
    """`cuda_time_ms` on a CUDA device; (None, []) on any other, where no
    device time exists to measure."""
    if torch.device(device).type != "cuda":
        return None, []
    return cuda_time_ms(fn, warmup, reps)


def alternate(kernel_fn, plain_fn):
    """Median CUDA-event times in turns plain, kernel, kernel, plain:
    (kernel ms, plain ms, the four medians)."""
    p1, _ = cuda_time_ms(plain_fn)
    k1, _ = cuda_time_ms(kernel_fn)
    k2, _ = cuda_time_ms(kernel_fn)
    p2, _ = cuda_time_ms(plain_fn)
    return statistics.median([k1, k2]), statistics.median([p1, p2]), (k1, k2, p1, p2)


def in_turns(fns: dict, warmup=2, reps=7):
    """Median CUDA-event times of each fn, measured in order and then in
    reverse order: name -> (first, second) medians in ms."""
    first = {name: cuda_time_ms(fn, warmup, reps)[0] for name, fn in fns.items()}
    second = {name: cuda_time_ms(fn, warmup, reps)[0] for name, fn in reversed(fns.items())}
    return {name: (first[name], second[name]) for name in fns}
