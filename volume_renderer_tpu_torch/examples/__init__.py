"""The port's examples: the JAX package's ``examples/*.py``, one script for
each, with the same flags, defaults and output files, plus ``--device``
(default: the card; ``cpu`` asks for the CPU). Run one as a module, e.g.
``python -m volume_renderer_tpu_torch.examples.example1``; each has
``main(argv=None)``. ``_data`` makes their synthetic data."""
