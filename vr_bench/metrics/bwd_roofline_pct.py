"""The lit scatter kernel (K6 ``march_bwd_lit_scatter_kernel`` or K6L
``march_bwd_lookup_scatter_kernel``, packed or not) against its least time
from the benchmark's own counts of operations, bytes and samples, the
replay's samples being the forward's, in percent."""

from vr_bench import roofline


def read(run):
    seconds = sum(t for name, t in run.trace.time_by_name().items()
                  if "march_bwd_" in name and "_scatter_kernel" in name)
    return roofline.share_pct(run.least["bwd"]["seconds"], seconds)
