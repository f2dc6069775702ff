"""The traced window: ``torch.profiler`` over the window, its Chrome trace
reduced to what the per-layer readers need: device time by kernel name,
the device's busy intervals, the idle gaps labelled with the benchmark's
own host span, and the benchmark's spans themselves.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "vr_bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A benchmark span around a call into the program: a profiler range
    (``vr_bench.<name>``) while tracing, nothing otherwise."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class Trace:
    window: Tuple[float, float]                       # seconds, the window span
    device_ops: List[Tuple[str, float, float]]        # (name, start, end) seconds
    spans: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, inside the window."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_ops if e > lo and s < hi)
        out: List[List[float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        lo, hi = self.window
        for name, s, e in self.device_ops:
            if e > lo and s < hi:
                out[name] = out.get(name, 0.0) + (e - s)
        return out

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds ``fragment``."""
        return sum(t for n, t in self.time_by_name().items() if fragment in n)

    def gaps(self) -> List[Tuple[str, float]]:
        """Every idle interval of the window, labelled with the innermost
        benchmark span that holds its middle ("none" outside any)."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                out.append((self.label_at((a + b) / 2), b - a))
        return out

    def label_at(self, t: float) -> str:
        best: Optional[Tuple[str, float, float]] = None
        for name, s, e in self.spans:
            if s <= t <= e and name != "window" and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else "none"

    def breakdown(self, top: int = 10) -> Dict:
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": [[n, t] for n, t in gaps]}


def from_chrome(events: List[Dict]) -> Trace:
    """Reduces a Chrome trace's events (microseconds) to a ``Trace``; the
    window is the benchmark's ``window`` span."""
    ops, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        name = ev.get("name", "")
        if ev.get("cat") in DEVICE_CATS:
            ops.append((name, s, e))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], s, e))
    windows = [(s, e) for n, s, e in spans if n == "window"]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    return Trace(window=windows[0], device_ops=ops, spans=spans)


@contextlib.contextmanager
def profiled(enabled: bool, holder: Dict):
    """Profiles the block where ``enabled``; ``holder["trace"]`` receives the
    reduced ``Trace`` afterwards. The Chrome trace goes through a file in
    the temporary directory, deleted once read."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    holder["trace"] = from_chrome(data["traceEvents"] if isinstance(data, dict) else data)
