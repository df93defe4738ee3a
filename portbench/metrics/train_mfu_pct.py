"""``train_mfu_pct``: the whole epoch's share of the card's peak: useful
operations an epoch over (the measured window's seconds an epoch × the
peak rate of the configuration's dtype), in percent."""


def read(run):
    pk = run.peaks
    if pk is None or not run.steps or run.window_s <= 0:
        return None
    per_step = run.window_s / run.steps
    return 100.0 * run.work["flops"] / (
        per_step * pk["flops"][run.config["dtype"]])
