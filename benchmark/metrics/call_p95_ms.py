"""call_p95_ms: the 95th percentile of the wall time of every call in
the window, from the call to its synchronize, on the host clock."""

import statistics


def read(run):
    if len(run.call_s) < 20:
        return None
    return statistics.quantiles(run.call_s, n=20)[-1] * 1e3
