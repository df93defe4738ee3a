"""``als.solve_host_ms``: host milliseconds an epoch inside the program's
``als/solve`` range (the enqueue and the wait inside MAGMA's batched
solve), from the program window's counters (:mod:`harness.program`)."""

from portbench.harness.program import per_epoch


def read(run):
    return per_epoch(run, "host_s", ["als/solve"], 1e3)
