"""``als_roofline``: the epoch's least time on this card over the summed
device time of every operation in a traced epoch, in percent. The least
time is the larger of the epoch's useful bytes over the memory
bandwidth and its useful operations over the peak rate of the
configuration's dtype (:mod:`harness.work`, from the configuration's
shapes). Nothing on a card without published peaks or without a
trace."""


def read(run):
    tr, pk = run.trace, run.peaks
    if tr is None or pk is None or not tr.steps or tr.device_s <= 0:
        return None
    least = max(run.work["bytes"] / pk["bytes_s"],
                run.work["flops"] / pk["flops"][run.config["dtype"]])
    return 100.0 * least / (tr.device_s / tr.steps)
