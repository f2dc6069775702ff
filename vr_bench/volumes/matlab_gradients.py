"""MATLAB's ``[gx, gy, gz] = gradient(V)`` of emission, as
``example1_grad.m`` makes its gradient volumes: central differences (numpy
``gradient`` semantics); on a (D, H, W) volume the first output
differentiates along the texture's y, the second along x."""

from __future__ import annotations

from typing import Dict

import torch


def make(spec: Dict, emission: torch.Tensor, device):
    return tuple(g.contiguous() for g in matlab_gradients(emission))


def central_differences(volume: torch.Tensor, axis: int) -> torch.Tensor:
    """(f[i+1] - f[i-1]) / 2 inside, one-sided at the two ends."""
    n = volume.shape[axis]
    out = torch.empty_like(volume)
    out.narrow(axis, 1, n - 2).copy_(
        (volume.narrow(axis, 2, n - 2) - volume.narrow(axis, 0, n - 2)) * 0.5)
    out.narrow(axis, 0, 1).copy_(volume.narrow(axis, 1, 1) - volume.narrow(axis, 0, 1))
    out.narrow(axis, n - 1, 1).copy_(volume.narrow(axis, n - 1, 1) - volume.narrow(axis, n - 2, 1))
    return out


def matlab_gradients(volume: torch.Tensor):
    return (central_differences(volume, 1), central_differences(volume, 2),
            central_differences(volume, 0))
