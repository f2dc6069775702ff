"""Every pixel of every frame whose image reached the host inside the
window, over the window's seconds."""


def read(run):
    w = run.window
    return w.rays / w.seconds if w.frames else None
