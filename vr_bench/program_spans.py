"""The program's own spans, put on the traced window's timeline.

The port records a span of its own work while a profiler runs
(``utils.profiling.spans()``: name, parent, host start and end in
nanoseconds on ``time.perf_counter_ns``, the card's milliseconds for a
device span). The reduced ``Trace`` keeps the benchmark's spans on the
profiler's clock, not the port's, so the two are aligned by enclosure:
each benchmark span ``render`` holds one ``facade.render`` and each
``step`` one ``train.step``, and the offset is the median gap between
their midpoints. A port without spans (an older commit) gives nothing.
"""

from __future__ import annotations

import statistics
from typing import List, NamedTuple, Optional

from vr_bench import program

# (benchmark span, the program's span it holds once)
ENCLOSING = (("render", "facade.render"), ("step", "train.step"))


class Placed(NamedTuple):
    """A program span on the trace's timeline, in seconds."""

    name: str
    start: float
    end: float
    device_ms: Optional[float]


def record():
    """The port's span record, or None where the port records none."""
    prof = getattr(getattr(program.port(), "utils", None), "profiling", None)
    spans = getattr(prof, "spans", None)
    return None if spans is None else spans()


def offset(trace, rec) -> Optional[float]:
    """Seconds to add to a record time (``perf_counter_ns`` x 1e-9) to put
    it on the trace's clock: the median gap between the midpoints of the
    latest enclosing pairs (the host's work between the two starts and
    that between the two ends largely cancel); None where no pair is found."""
    for outer, inner in ENCLOSING:
        a = sorted((s + e) / 2 for name, s, e in trace.spans if name == outer)
        b = sorted(0.5e-9 * (sp.start_ns + sp.end_ns) for sp in rec if sp.name == inner)
        n = min(len(a), len(b))
        if n:
            return statistics.median(x - y for x, y in zip(a[-n:], b[-n:]))
    return None


def placed(run) -> Optional[List[Placed]]:
    """The record's spans that lie inside the traced window, on the
    trace's timeline; None without a trace, a record or an alignment."""
    tr = run.trace
    if tr is None:
        return None
    rec = record()
    if not rec:
        return None
    shift = offset(tr, rec)
    if shift is None:
        return None
    lo, hi = tr.window
    out = []
    for sp in rec:
        s, e = 1e-9 * sp.start_ns + shift, 1e-9 * sp.end_ns + shift
        if lo <= s and e <= hi:
            out.append(Placed(sp.name, s, e, sp.device_ms))
    return out


def _per(run) -> int:
    return run.window.frames or run.window.steps


def host_ms(run, name: str) -> Optional[float]:
    """Host milliseconds inside the spans ``name`` a frame or step."""
    spans = [p for p in placed(run) or () if p.name == name]
    if not spans or not _per(run):
        return None
    return 1e3 * sum(p.end - p.start for p in spans) / _per(run)


def device_ms(run, name: str) -> Optional[float]:
    """The card's milliseconds between the edges of the device spans
    ``name`` a frame or step; None where they carry no device time."""
    spans = [p for p in placed(run) or () if p.name == name]
    if not spans or not _per(run) or any(p.device_ms is None for p in spans):
        return None
    return sum(p.device_ms for p in spans) / _per(run)


def idle_inside(run, name: str) -> Optional[float]:
    """Seconds of the window in which the card ran no operation while the
    host was inside a span ``name`` (spans of one name do not overlap: the
    program runs on one thread and does not nest a span in its own name);
    None without device operations."""
    tr = run.trace
    spans = [p for p in placed(run) or () if p.name == name]
    if not spans or not tr.device_ops:
        return None
    busy = tr.busy_intervals()
    idle, j = 0.0, 0
    for s, e in sorted((p.start, p.end) for p in spans):
        covered = 0.0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return idle
