"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the timed
window, reset after warm-up.  The window keeps no answer, and the
answers checked and the reference come after it is read, so it is the
program's inputs and one call's working set."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
