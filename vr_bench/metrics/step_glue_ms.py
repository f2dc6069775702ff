"""Device milliseconds a step outside the two march kernels: K5's pack,
the accumulators' zeroing and unpacking, the loss and the residual,
Adam's operations (every device operation of the window but the forward
and backward march kernels, over the steps)."""


def read(run):
    if not run.window.steps or not run.trace.device_ops:
        return None
    total = 0.0
    for name, t in run.trace.time_by_name().items():
        march = "march_kernel" in name or ("march_bwd_" in name and "_scatter_kernel" in name)
        if not march:
            total += t
    return 1e3 * total / run.window.steps
