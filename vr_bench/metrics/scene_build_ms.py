"""Host milliseconds a frame inside the program's ``facade.build_scene``
span: the scene of the renderer's state (dedup, the default reflection
volume, lights, camera, settings)."""

from vr_bench import program_spans


def read(run):
    return program_spans.host_ms(run, "facade.build_scene")
