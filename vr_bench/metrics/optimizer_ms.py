"""The card's milliseconds a step between the edges of the program's
``train.optimizer`` span (CUDA events): the optimizer's step."""

from vr_bench import program_spans


def read(run):
    return program_spans.device_ms(run, "train.optimizer")
