"""Named-slot accumulating stopwatch (port of
``volume_renderer_tpu.utils.stopwatch``).

The reference's MATLAB Stopwatch (Stopwatch.m): named timer slots with
tic/toc accumulation and a formatted report, on the host's clock. Work on
a card is asynchronous: pass what it computes as ``sync`` to ``stop`` and
the clock stops once the card has finished it.
"""

from __future__ import annotations

import time
from typing import Dict

import torch


def synchronize(obj) -> None:
    """Waits for every CUDA device that holds a tensor in ``obj`` (a tensor,
    or a list, tuple or dict of them, nested). Tensors on the CPU need no
    wait. An error of the card surfaces here."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(obj)
    for device in devices:
        torch.cuda.synchronize(device)


class Stopwatch:
    def __init__(self, title: str = "timings"):
        self.title = title
        self._labels: Dict[str, str] = {}
        self._elapsed: Dict[str, float] = {}
        self._started: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def add(self, key: str, label: str) -> None:
        self._labels[key] = label
        self._elapsed.setdefault(key, 0.0)
        self._counts.setdefault(key, 0)

    def start(self, key: str) -> None:
        if key not in self._labels:
            self.add(key, key)
        self._started[key] = time.perf_counter()

    def stop(self, key: str, sync=None) -> float:
        """Stops a slot and returns its seconds; with ``sync`` (tensors, see
        ``synchronize``) after the card has finished them."""
        if sync is not None:
            synchronize(sync)
        dt = time.perf_counter() - self._started.pop(key)
        self._elapsed[key] += dt
        self._counts[key] += 1
        return dt

    def elapsed(self, key: str) -> float:
        return self._elapsed.get(key, 0.0)

    def count(self, key: str) -> int:
        return self._counts.get(key, 0)

    def report(self) -> str:
        lines = [f"== {self.title} =="]
        for key, label in self._labels.items():
            n = self._counts.get(key, 0)
            total = self._elapsed.get(key, 0.0)
            mean = total / n if n else 0.0
            lines.append(f"  [{key}] {label}: total {total * 1e3:.2f} ms over {n} runs "
                         f"(mean {mean * 1e3:.2f} ms)")
        return "\n".join(lines)

    def print(self) -> None:
        print(self.report())
