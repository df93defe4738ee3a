"""``device_idle_pct``: the share of the traced window in which no
device operation runs, from the profiler's timeline."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.n_device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
