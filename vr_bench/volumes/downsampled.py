"""Emission at a lower resolution, normalised: the mean of each
``downsample``^3 block (the benchmark's own interpolation), then scaled
onto ``normalize`` = [lo, hi]."""

from __future__ import annotations

from typing import Dict

import torch


def make(spec: Dict, emission: torch.Tensor, device) -> torch.Tensor:
    return normalized(downsample(emission, spec["downsample"]), *spec["normalize"])


def downsample(volume: torch.Tensor, factor: int) -> torch.Tensor:
    pooled = torch.nn.functional.avg_pool3d(volume[None, None], factor)
    return pooled[0, 0].contiguous()


def normalized(volume: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    mn, mx = volume.min(), volume.max()
    return ((volume - mn) * (hi - lo) / (mx - mn) + lo).contiguous()
