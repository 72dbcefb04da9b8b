"""device: the share of the window in which nothing ran on the card, in %:
1 - (union of the device intervals) / (the window's wall time)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
