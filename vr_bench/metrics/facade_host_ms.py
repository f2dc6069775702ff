"""Host milliseconds of each ``render()`` call until it returns, before the
readback (scene build, dedup, plan, launch), the mean over the window's
frames: the benchmark's own span, read in the traced run."""


def read(run):
    host = run.window.host_s
    return 1e3 * sum(host) / len(host) if host else None
