"""``als.stats_host_ms``: host milliseconds an epoch inside the program's
``als/gather_gramian`` and ``als/heavy_add`` ranges, from the program
window's counters (:mod:`harness.program`)."""

from portbench.harness.program import per_epoch


def read(run):
    return per_epoch(run, "host_s", ["als/gather_gramian", "als/heavy_add"], 1e3)
