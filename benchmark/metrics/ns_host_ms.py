"""ns_host_ms: per call, the device's idle time in the traced window's
gaps during which the host sat inside the program's ``hbsm.inv_sqrt`` or
``hbsm.engine_check`` span with no PyTorch operator open: the
Newton-Schulz driver's own Python code and the engine's host reads, as
the breakdown's idle gaps ``bench.call/hbsm.inv_sqrt`` and
``bench.call/hbsm.engine_check`` hold them (``trace.label_gaps``).  None
without a device timeline or where no call runs the engine."""

GAPS = ("bench.call/hbsm.inv_sqrt", "bench.call/hbsm.engine_check")


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or t.calls == 0:
        return None
    if not any(g in t.idle_seconds for g in GAPS):
        return None
    return 1e3 * sum(t.idle_seconds.get(g, 0.0) for g in GAPS) / t.calls
