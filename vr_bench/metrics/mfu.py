"""The whole window's share of the card's float32 peak: the operations of
every frame or step of the window (forward, and backward in a fit) by the
benchmark's own count (``roofline.py``, the samples of the benchmark's
walk), over the window's seconds and 67 TFLOP/s, in percent. It bounds the
kernels' rooflines: a kernel taken off the path leaves its own share
silent, not this one."""

from vr_bench import roofline


def read(run):
    if run.window.seconds <= 0:
        return None
    return 100.0 * run.least["flops"] / (run.window.seconds * roofline.PEAK_FP32_FLOPS)
