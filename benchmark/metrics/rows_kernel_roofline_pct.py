"""rows_kernel_roofline_pct: the least time the card needs for the traced
calls' products (as ``kernel_roofline_pct`` counts it) over the device
time of the row-panel kernel alone (the operations whose name holds
``rows_spgemm_kernel``, ``kernels/csrc/gemm_rows.cu``), in percent.
None without a device timeline or where the row-panel kernel did not
run."""

KERNEL = "rows_spgemm_kernel"


def read(run):
    t = run.trace
    if t is None or run.least_s <= 0:
        return None
    rows_s = sum(s for name, s in t.op_seconds.items() if KERNEL in name)
    if rows_s <= 0:
        return None
    return 100.0 * run.least_s / rows_s
