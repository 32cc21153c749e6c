"""Build, load, bind and launch the port's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with ctypes.  Libraries live in
``build/hbsm_torch/`` at the repository root, named by a hash of the
sources and flags: a changed source builds anew, an unchanged one loads
from disk.  A failed build raises.  Nothing here runs at import time.

The calling convention every source shares: each C entry returns a CUDA
error code (0 for success) unless its wrapper's table says otherwise, a
launch takes the stream last, and ``hbsm_cuda_error_string`` names a
code.  A wrapper declares its entries' arguments once (`bind`) and calls
them through `launch` (on a device's current stream) or `check`; data
types and precision tiers go in as `DTYPE_CODES` and `PRECISION_CODES`
give them, factors as `scalar_arg` does, index tables checked by
`check_index` and blocks 16-byte aligned (`aligned16`).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import subprocess
import time

import torch

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

# name -> the library `bind` declared, once a process.
_BOUND: dict[str, ctypes.CDLL] = {}

# The kernels' data types and precision tiers, by the codes their
# entries take.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
PRECISION_CODES = {"highest": 0, "high": 1, "default": 2}


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


def bind(name: str, signatures: dict, restypes: dict | None = None) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (`load`), its entries declared
    once a process: each of `signatures` (entry name -> argtypes) returns
    an int error code, or the type `restypes` gives it, and
    ``hbsm_cuda_error_string`` is bound."""
    lib = _BOUND.get(name)
    if lib is None:
        lib = load(name)
        for fn, args in signatures.items():
            entry = getattr(lib, fn)
            entry.restype = (restypes or {}).get(fn, ctypes.c_int)
            entry.argtypes = args
        lib.hbsm_cuda_error_string.restype = ctypes.c_char_p
        lib.hbsm_cuda_error_string.argtypes = [ctypes.c_int]
        _BOUND[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise ``RuntimeError("<what>: <CUDA error>")`` on a nonzero code."""
    if err != 0:
        raise RuntimeError(f"{what}: {lib.hbsm_cuda_error_string(err).decode()}")


def launch(lib: ctypes.CDLL, fn: str, what: str, device: torch.device, *args) -> None:
    """Call `lib`'s entry `fn` with `args` and the current stream of
    `device` last, with `device` current (switched only when it is
    another); `check` its code under `what`."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(lib, fn, what, device, *args)
    # The raw stream handle, from the private entry that torch.compile's
    # generated code calls (torch 2.x): building a torch.cuda.Stream object
    # instead costs a small kernel's whole launch again on the host.
    check(lib, getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(device.index)), what)


def scalar_arg(x, dtype, device):
    """A factor as the kernels take it: (device scalar of `dtype` or None,
    host value).  A tensor on the card stays there (no host sync); a
    number or a CPU tensor is read on the host, a tensor after the cast to
    `dtype` that torch's scale makes."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            return None, float(x.to(dtype))
        if x.device != device:
            raise ValueError(f"factor on {x.device}, data on {device}")
        return x.to(dtype).reshape(1).contiguous(), 0.0
    return None, float(x)


def check_index(name: str, t: torch.Tensor, length: int, device) -> None:
    """Raise unless `t` is a contiguous 1-D int32 tensor of `length` on
    `device`: what an entry reads through an index table's pointer."""
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 1-D int32 tensor")
    if t.shape[0] != length:
        raise ValueError(f"{name}: length {t.shape[0]}, expected {length}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, operands on {device}")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address (a copy if it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
