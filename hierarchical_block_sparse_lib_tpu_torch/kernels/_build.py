"""Build and load the port's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ctypes.  Libraries live in
``build/hbsm_torch/`` at the repository root, named by a hash of the
sources and flags: a changed source builds anew, an unchanged one loads
from disk.  A failed build raises.  Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "hbsm_torch",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

# name -> (seconds, compiler output) for the builds this process ran.
build_logs: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        h.update(fname.encode())
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    """Where the library built from ``csrc/<name>.cu`` lives (for
    ``cuobjdump``; `load` builds it)."""
    return os.path.join(BUILD_DIR, f"lib{name}_{_source_hash()}.so")


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed
    (callers keep the handle: each call hashes the sources again)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    so = library_path(name)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) on {src}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)
        build_logs[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return ctypes.CDLL(so)


def load_all(names) -> dict[str, ctypes.CDLL]:
    """`load` each of `names` at once: one nvcc per source, all started
    together.  Returns name -> library; the first failed build raises."""
    with concurrent.futures.ThreadPoolExecutor(max(len(names), 1)) as pool:
        futures = {name: pool.submit(load, name) for name in names}
        return {name: f.result() for name, f in futures.items()}
