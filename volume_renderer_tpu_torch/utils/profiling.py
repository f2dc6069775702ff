"""Profiler traces and phase timing (port of
``volume_renderer_tpu.utils.profiling``).

- ``trace(logdir)`` profiles a block with ``torch.profiler``: the host's
  operators and, with a CUDA card, every kernel launched on it, the
  port's own among them. It writes one Chrome-trace JSON file into
  ``logdir`` that TensorBoard's profiler plugin and Perfetto open.
- ``PhaseTimer`` sums wall-clock phases on the host's clock; each phase
  waits for the card before its clock stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

import torch

from volume_renderer_tpu_torch.utils.stopwatch import synchronize


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block; yields the ``torch.profiler.profile`` (for
    ``key_averages()``). On exit the trace is written to
    ``logdir/<host>_<pid>.<time>.pt.trace.json``, its path in the
    profile's ``trace_path``."""
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
