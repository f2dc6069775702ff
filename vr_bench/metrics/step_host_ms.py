"""Host milliseconds a step inside the program's ``train.step`` span: the
step's enqueue. Where it nears ``step_ms``, the host sets the pace."""

from vr_bench import program_spans


def read(run):
    return program_spans.host_ms(run, "train.step")
