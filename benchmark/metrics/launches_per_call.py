"""launches_per_call: device operations (kernels, copies, memsets) the
profiler recorded in the traced window, per call."""


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or t.calls == 0:
        return None
    return t.device_ops / t.calls
