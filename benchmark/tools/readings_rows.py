"""``readings.py`` for the cells that run the row-panel kernel
(``b4full.colslab``): the same readings, with the three faults of
``benchmark/faults.py`` planted at ``rows_spgemm`` in place of the fine
kernel.

    python3 benchmark/tools/readings_rows.py --workload b4full.colslab \
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7 --seconds 1

Not run by the benchmark itself.
"""

from __future__ import annotations

import contextlib
import os
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def planted(fault: str):
    """Within the block, the row-panel kernel runs with `fault`."""
    from benchmark import faults
    from hierarchical_block_sparse_lib_tpu_torch.kernels import pallas_gemm_rows

    if fault not in faults.FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    rows = faults._kernel_fault(pallas_gemm_rows.rows_spgemm, fault)
    with mock.patch.object(pallas_gemm_rows, "rows_spgemm", rows):
        yield


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from benchmark import faults
    from benchmark.tools import readings

    with mock.patch.object(faults, "planted", planted):
        return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
