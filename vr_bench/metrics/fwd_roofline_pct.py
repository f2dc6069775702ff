"""The forward march kernel (K4 or K5, ``march_kernel`` in the trace; K5's
pack not counted) against its least time from the benchmark's own counts
of operations, bytes and samples (``roofline.py``), in percent."""

from vr_bench import roofline


def read(run):
    return roofline.share_pct(run.least["fwd"]["seconds"],
                              run.trace.kernel_seconds("march_kernel"))
