"""kernel_roofline_pct: the least time the card needs for the traced
calls' products (``counts.py``: the larger of their FLOPs over the
configured precision's peak and their least bytes over the memory
rate, ``peaks.json``) over the device time of every operation the calls
launched, in percent."""


def read(run):
    t = run.trace
    if t is None or t.op_s <= 0 or run.least_s <= 0:
        return None
    return 100.0 * run.least_s / t.op_s
