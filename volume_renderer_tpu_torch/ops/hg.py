"""Henyey-Greenstein illumination LUT (port of ``volume_renderer_tpu.ops.hg``).

For cell (c, a, b) of an N^3 cube, gamma = c*pi/N, alpha = a*pi/N,
beta = b*pi/N:

    cos_theta = sin a * sin b + cos g * cos a * cos b
    HG = 1/(4 pi) * (1 - g^2) / (1 + g^2 - 2 g cos_theta)^(3/2)

stored as (c, a, b) in C order, so normalized texture coordinate x maps to
the b axis, y to a, z to c.
"""

from __future__ import annotations

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device


def henyey_greenstein_lut(n: int, g: float = 0.8, device: DeviceLike = None) -> torch.Tensor:
    """N^3 float32 LUT of the Henyey-Greenstein phase function."""
    if not -1.0 <= float(g) <= 1.0:
        raise ValueError("g must be in interval [-1,1]")
    dev = resolve_device(device)
    pi = np.float32(np.pi)
    frac = float(pi / np.float32(n))
    idx = torch.arange(n, dtype=torch.float32, device=dev) * frac

    gamma = idx[:, None, None]  # c axis
    alpha = idx[None, :, None]  # a axis
    beta = idx[None, None, :]  # b axis

    cos_theta = torch.sin(alpha) * torch.sin(beta) + torch.cos(gamma) * torch.cos(alpha) * torch.cos(beta)

    g32 = np.float32(g)
    numerator = np.float32(1.0) - g32 * g32
    base = float(np.float32(1.0) + g32 * g32) - float(np.float32(2.0) * g32) * cos_theta
    denominator = torch.sqrt(base * base * base)
    coef = (np.float32(1.0) / (np.float32(4.0) * pi)) * numerator
    # an explicit division: python-scalar / tensor would multiply by the
    # reciprocal and round differently
    return torch.full_like(denominator, float(coef)).div_(denominator).contiguous()
