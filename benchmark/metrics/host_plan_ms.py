"""host_plan_ms: per call, the device's idle time in the traced window's
gaps during which the host sat inside the program's ``hbsm.host_plan``
span with no PyTorch operator open: the host planner's own code (the C++
plan over the ids read to the host), as the breakdown's idle gap
``bench.call/hbsm.host_plan`` holds it (``trace.label_gaps``).  None
without a device timeline or where no call plans on the host."""

GAP = "bench.call/hbsm.host_plan"


def read(run):
    t = run.trace
    if t is None or t.device_ops == 0 or t.calls == 0 or GAP not in t.idle_seconds:
        return None
    return 1e3 * t.idle_seconds[GAP] / t.calls
