"""The card's milliseconds a frame or step between the edges of the
program's ``march.pack`` span (CUDA events): K5's (D, H, W, 4) pack."""

from vr_bench import program_spans


def read(run):
    return program_spans.device_ms(run, "march.pack")
