"""``als.stream_drains``: entries an epoch into the program's ALS ranges
at which the card's stream was already empty (the card idle, waiting
for the host), from the program window's counters
(:mod:`harness.program`)."""

from portbench.harness.program import per_epoch


def read(run):
    return per_epoch(run, "drains", ["als/gather_gramian", "als/heavy_add", "als/solve"])
