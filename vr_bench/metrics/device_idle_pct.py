"""The share of the traced window in which no kernel, copy or memset ran on
the card, in percent (the profiler's device timeline); nothing where the
trace holds no device operation."""


def read(run):
    tr = run.trace
    if not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
