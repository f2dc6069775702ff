"""Host milliseconds a frame inside the program's ``facade.plan`` span:
the memory planner, the card's free memory read included."""

from vr_bench import program_spans


def read(run):
    return program_spans.host_ms(run, "facade.plan")
