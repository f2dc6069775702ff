"""Host milliseconds a frame inside the program's ``march.forward`` span:
the forward kernel's arguments and checks, its output, the enqueue of
K5's pack and the launch."""

from vr_bench import program_spans


def read(run):
    return program_spans.host_ms(run, "march.forward")
