"""The share of the traced epoch's host interval in which no operation
ran on the device."""


def read(run):
    t = run.traced
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
