"""The share of the traced window in which the card ran no operation while
the host was inside the program's ``facade.render`` span, in percent: the
part of ``device_idle_pct`` that lies inside ``render()``."""

from vr_bench import program_spans


def read(run):
    idle = program_spans.idle_inside(run, "facade.render")
    if idle is None or run.trace.window_s <= 0:
        return None
    return 100.0 * idle / run.trace.window_s
