"""leaf_gflops: 2 * b^3 * leaf-block pairs of every call completed in the
window (counted by ``counts.py`` from the inputs, for SP2 from the
reference's own iterates), over the window's seconds on the host clock."""


def read(run):
    if run.window_s <= 0 or run.flops <= 0:
        return None
    return run.flops / run.window_s / 1e9
