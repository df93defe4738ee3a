"""``train_ratings_per_s``: interactions × epochs completed in the
measured window, over the window's host-clock seconds from the first
enqueue to the closing synchronize. One rate over the whole window."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return run.work["ratings"] * run.steps / run.window_s
