"""``als.pack_s``: seconds of the program's own ``als/pack`` spans (both
sides' ``build_bucketed``) in the set-up of the program window
(:mod:`harness.program`)."""

from portbench.harness.program import pack_s


def read(run):
    return pack_s(run)
