"""``setup_s``: the process's start to the first timed enqueue (imports,
generation, packing, staging, warm-up)."""


def read(run):
    return run.setup_s
