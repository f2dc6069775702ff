"""Data generators, one module each, named by a configuration's
``data.generator``: ``make(spec, device, n=None)`` returns the emission
volume, (D, H, W) float32 on the device, made from ``spec`` (``n``
overrides its size for the CPU tests)."""
