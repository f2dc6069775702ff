"""The 95th percentile of the window's frames, each from the ``render()``
call until its image is on the host (linear between order statistics)."""

import statistics


def read(run):
    frames = run.window.frame_s
    if len(frames) < 2:
        return None
    return 1e3 * statistics.quantiles(frames, n=100, method="inclusive")[94]
