"""Seconds from the process's start to the window's first frame or step:
import, kernel loading (and, on a checkout's first run, their build), the
inputs made on the card, and the warm-up."""


def read(run):
    return run.setup_s
