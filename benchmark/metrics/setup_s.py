"""setup_s: process start to the first timed call: imports, the card,
kernel builds or cache loads, inputs, plans and warm-up."""


def read(run):
    return run.setup_s
