"""Time the micro kernels of this checkout of the repository and of others
on one CUDA card, in turns: the others in order, this one twice, the others
in reverse.

    python hierarchical_block_sparse_lib_tpu_torch/scripts/time_micro_designs.py OTHER_ROOT...

Each OTHER_ROOT holds another checkout: the parent commit, unpacked with
``git archive``, or a copy of this one with a variant of a kernel's source
in place (the way a design that was tried is timed against the one kept).
Each turn is a process of its own that imports the port from one root,
builds that root's kernels into that root's ``build/``, and times, with
that root's `utils.profiling.cuda_time_ms`, the calls of `micro` "wide" at
832 and "quad" at 896 at both tiers, `e3` at R3 = 4096 and `e2` "reshape"
through the wrappers every checkout has, and `e12` at RA = 256, nbrow = 26
("highest" and "default" with the adds, "highest" without), its call and
its kernel's device µs per launch
(torch.profiler over 10 calls).
Prints one JSON line per turn and every design's numbers beside the card's
name and power limit.  Exits non-zero without a card.  `run_turns` is the
turn machinery; scripts/time_tile_designs.py uses it too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
THIS_ROOT = os.path.dirname(os.path.dirname(HERE))


def measure(root: str) -> dict:
    """name -> ms per call (median of 7 after 2 warm-ups), with the port
    imported from `root`."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from hierarchical_block_sparse_lib_tpu_torch.kernels import micro_fine as mf
    from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import cuda_time_ms

    rng = np.random.default_rng(0)

    def normal(*shape, scale=0.1):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).cuda()

    at, bp, atq, bpq = normal(32, 832), normal(32, 832), normal(32, 896), normal(32, 896)
    idx = torch.from_numpy(rng.integers(0, 500, 4096).astype(np.int32)).cuda()
    v, x = normal(8, 128, scale=1.0), normal(32, 32, scale=1.0)
    calls = {
        "micro wide 832 highest": lambda: mf.micro(at, bp, "wide"),
        "micro quad 896 highest": lambda: mf.micro(atq, bpq, "quad"),
        "micro wide 832 default": lambda: mf.micro(at, bp, "wide", "default"),
        "micro quad 896 default": lambda: mf.micro(atq, bpq, "quad", "default"),
        "e3 R3=4096": lambda: mf.e3(idx, v),
        "e2 reshape": lambda: mf.e2(x, "reshape"),
    }
    out = {name: cuda_time_ms(fn)[0] for name, fn in calls.items()}
    # e12 at RA = 256, nbrow = 26 (scripts/micro_fine_kernel2.py's sizes):
    # the call and the kernel's device time per launch.
    from hierarchical_block_sparse_lib_tpu_torch.scripts.time_tile_designs import device_us

    a_wide, panel = normal(256, 32, 128), normal(8 * 26, 128)
    idx12 = torch.from_numpy(rng.integers(0, 500, 256 * 26).astype(np.int32)).cuda()
    for name, fn in {
        "e12 highest adds": lambda: mf.e12(a_wide, panel, idx12),
        "e12 default adds": lambda: mf.e12(a_wide, panel, idx12, "default"),
        "e12 highest no adds": lambda: mf.e12(a_wide, panel, idx12, do_adds=False),
    }.items():
        out[f"{name}: call ms"] = cuda_time_ms(fn)[0]
        out[f"{name}: device us"] = device_us(fn, "e12_kernel")
    return out


def run_turns(script: str, other_roots: list[str]) -> int:
    """Run ``python SCRIPT --measure ROOT`` for the other checkouts in
    order, this one twice, then the others in reverse (each turn a process
    of its own, which prints one JSON object of name -> number as its last
    line); print each turn's JSON line and then every design's numbers
    side by side, under the card's name and power limit.  An other
    checkout is labelled by its directory's name.  Returns 2 without a
    card, a failed turn's exit code, or 0."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, THIS_ROOT)
    from hierarchical_block_sparse_lib_tpu_torch.utils.profiling import card_line

    roots = {os.path.basename(os.path.abspath(r)): os.path.abspath(r) for r in other_roots}
    others = list(roots)
    roots["this"] = THIS_ROOT
    order = [*others, "this", "this", *reversed(others)]
    turns = []
    for label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(script), "--measure",
                               roots[label]], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": label, "root": roots[label], "measured": rec}))
        turns.append((label, rec))
    print(f"{card_line()}: turns {', '.join(order)}")
    width = max(len(label) for label in roots)
    for name in turns[0][1]:
        for label in roots:
            vals = " / ".join(f"{r[name]:.4f}" for lab, r in turns if lab == label)
            print(f"  {name:34s} {label:{width}s} {vals}")
    return 0


def main(*other_roots: str) -> int:
    """The micro kernels' call ms (median of 7 after 2 warm-ups) in turns."""
    return run_turns(__file__, list(other_roots))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(*sys.argv[1:]))
