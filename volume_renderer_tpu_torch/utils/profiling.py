"""Profiler traces, the program's spans, and phase timing (port of
``volume_renderer_tpu.utils.profiling``).

- ``trace(logdir)`` profiles a block with ``torch.profiler``: the host's
  operators and, with a CUDA card, every kernel launched on it, the
  port's own among them. It writes one Chrome-trace JSON file into
  ``logdir`` that TensorBoard's profiler plugin and Perfetto open.
- ``span(name)`` names a stretch of the program's own work. It is on only
  while a ``torch.profiler`` runs (``trace``, or any other profile): then
  the stretch is a ``record_function`` range ``vr.<name>`` in the trace,
  beside the kernels, and an entry of the in-memory record that
  ``spans()`` returns. With no profiler running it costs one flag read and
  records nothing.
- ``PhaseTimer`` sums wall-clock phases on the host's clock; each phase
  waits for the card before its clock stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from volume_renderer_tpu_torch.utils.stopwatch import synchronize


# the record's bound: entries past it are dropped and counted
SPAN_LIMIT = 2 ** 20


class Span(NamedTuple):
    """One entry of the record: ``parent`` is the index of the enclosing
    span's entry (-1 for none); ``start_ns`` and ``end_ns`` are host times
    on ``time.perf_counter_ns`` (the monotonic clock); ``device_ms`` is the
    card's time between the span's edges (``span(..., device=True)`` with
    CUDA in use), else None."""

    name: str
    parent: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


class SpanRecord:
    """The spans recorded while a profiler ran, in the order they began, at
    most ``limit`` of them (``dropped`` counts the rest). Device spans keep
    their two CUDA events until the record is read."""

    def __init__(self, limit: int = SPAN_LIMIT):
        self.limit = limit
        self.dropped = 0
        self._entries: List[list] = []    # [name, parent, start, end, events or ms]
        self._open: List[int] = []        # indices of the spans entered, innermost last
        self._pending: List[list] = []    # entries whose events are not yet resolved

    def clear(self) -> None:
        self._entries.clear()
        self._open.clear()
        self._pending.clear()
        self.dropped = 0

    def spans(self) -> List[Span]:
        """The record; waits for the card first where device spans are
        unresolved."""
        if self._pending:
            torch.cuda.synchronize()
            for entry in self._pending:
                start, end = entry[4]
                entry[4] = start.elapsed_time(end)
            self._pending.clear()
        return [Span(*e) for e in self._entries]


class _Span:
    """A span while a profiler runs: a ``record_function`` range and an
    entry of ``RECORD``, its host times read inside the range."""

    __slots__ = ("name", "device", "range", "index", "entry", "events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        self.range = torch.profiler.record_function("vr." + self.name)
        self.range.__enter__()
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.entry = None
        if len(RECORD._entries) < RECORD.limit:
            self.index = len(RECORD._entries)
            parent = RECORD._open[-1] if RECORD._open else -1
            self.entry = [self.name, parent, time.perf_counter_ns(), 0, None]
            RECORD._entries.append(self.entry)
            RECORD._open.append(self.index)
        else:
            RECORD.dropped += 1
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        if self.entry is not None:
            self.entry[3] = time.perf_counter_ns()
            if RECORD._open and RECORD._open[-1] == self.index:
                RECORD._open.pop()
            if self.events is not None:
                self.entry[4] = self.events
                RECORD._pending.append(self.entry)
        return False


RECORD = SpanRecord()
_OFF = contextlib.nullcontext()


def span(name: str, device: bool = False):
    """A span of the program's work named ``name``: while a
    ``torch.profiler`` runs, the range ``vr.<name>`` and an entry of the
    record (``spans()``); ``device=True`` also times the card between the
    span's edges with two CUDA events on the current stream (host times
    alone where CUDA is not in use). With no profiler running, a shared
    no-op after one flag read."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def spans() -> List[Span]:
    """The spans recorded since the last ``clear()`` (``trace`` clears on
    entry)."""
    return RECORD.spans()


def clear() -> None:
    """Empties the record and its count of dropped spans."""
    RECORD.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block; yields the ``torch.profiler.profile`` (for
    ``key_averages()``). On exit the trace is written to
    ``logdir/<host>_<pid>.<time>.pt.trace.json``, its path in the
    profile's ``trace_path``. Clears the span record on entry, so that
    ``spans()`` afterwards holds the block's spans alone.

    The program's ranges (``span``), each ``vr.<name>`` in the trace:

    - ``facade.render``: ``VolumeRenderer.render``, whole (a stereo
      frame's two passes nest under it);
    - ``facade.build_scene``: the scene of the renderer's state (dedup,
      the default reflection volume, lights, camera, settings);
    - ``facade.plan``: ``plan_render``, the device's free memory included;
    - ``march.forward``: ``render_rows_fast`` (arguments, checks, output,
      the pack's enqueue, the forward kernel's launch);
    - ``march.pack`` (device): ``pack_lookup``, K5's (D, H, W, 4) pack;
    - ``march.backward``: ``march_backward`` (accumulators zeroed, the
      backward kernel's launch, unpacking);
    - ``train.step``: ``train.train_step_fast``, whole;
    - ``train.optimizer`` (device): its ``optimizer.step()``.
    """
    RECORD.clear()
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    before = set(os.listdir(logdir))
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
    written = sorted(set(os.listdir(logdir)) - before)
    prof.trace_path = os.path.join(logdir, written[-1]) if written else None


def _wait_for_the_card(results: Optional[list]) -> None:
    if results:
        synchronize(results)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Named wall-clock phases; each waits for the card before its clock
    stops (the current CUDA device, and every device its results lie on)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def phase(self, name: str, result_holder: Optional[list] = None):
        """Times a block; tensors the block appends to ``result_holder`` are
        waited for too."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _wait_for_the_card(result_holder)
            self._add(name, time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs) -> Any:
        """Runs ``fn``, waits for its result on the card and accounts it
        under ``name``; returns the result."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait_for_the_card([out])
        self._add(name, time.perf_counter() - t0)
        return out

    def report(self) -> str:
        lines = ["phase breakdown:"]
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            share = 100.0 * t / total if total else 0.0
            lines.append(
                f"  {name}: {t * 1e3:.1f} ms over {n} call(s) "
                f"({t / n * 1e3:.1f} ms each, {share:.0f}%)")
        lines.append(f"  total: {total * 1e3:.1f} ms")
        return "\n".join(lines)
