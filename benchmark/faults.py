"""Faults planted in the program under the timed path, to show that the
check catches them (``tests/test_bench_faults.py`` on the CPU,
``tools/readings.py`` on the card).  Never used by a run of the benchmark.

- ``"unchanged"``: a step returns its state unchanged: the product
  kernel returns its output slots as they start, zero;
- ``"half"``: half of the batch left out and the mean taken over the
  rest: every other B block is left out of the product kernel's pairs
  and the result doubled;
- ``"altered"``: an answer altered where it is produced: one element of
  the product kernel's first output block moved by 1e-3 of its
  largest magnitude.

One chip only, so the fault of an exchange between chips has no cell.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_fine
from hierarchical_block_sparse_lib_tpu_torch.ops import fine as fine_ops

FAULTS = ("unchanged", "half", "altered")


def _kernel_fault(kernel, fault):
    def broken(*args, **kw):
        if fault == "half":
            args = list(args)
            b_data = args[3].clone()
            b_data[1::2] = 0
            args[3] = b_data
            return 2 * kernel(*args, **kw)
        out = kernel(*args, **kw)
        if fault == "unchanged":
            return torch.zeros_like(out)
        out = out.clone()
        flat = out[0].reshape(-1)
        flat[0] += 1e-3 * out.abs().max()
        return out

    # The kernel's wrapper counts its launches on the module's name, now this.
    broken.launches = 0
    return broken


@contextlib.contextmanager
def planted(fault: str):
    """Within the block, the program runs with `fault`."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    fine = _kernel_fault(pallas_gemm_fine.fine_spgemm, fault)
    with mock.patch.object(pallas_gemm_fine, "fine_spgemm", fine), \
            mock.patch.object(fine_ops, "fine_spgemm", fine):
        yield
