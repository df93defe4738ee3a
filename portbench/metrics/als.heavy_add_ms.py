"""``als.heavy_add_ms``: device milliseconds an epoch of the operations launched
inside the program's ``als/heavy_add`` profiler range, from the traced window."""

from portbench.harness.trace import range_ms


def read(run):
    return range_ms(run, "als/heavy_add")
