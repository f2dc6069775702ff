"""The window's seconds over the steps it completed (it ends with a
synchronise), in milliseconds."""


def read(run):
    w = run.window
    return 1e3 * w.seconds / w.steps if w.steps else None
