"""``als.gather_gramian_ms``: device milliseconds an epoch of the operations launched
inside the program's ``als/gather_gramian`` profiler range, from the traced window."""

from portbench.harness.trace import range_ms


def read(run):
    return range_ms(run, "als/gather_gramian")
