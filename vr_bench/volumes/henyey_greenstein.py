"""The (c, a, b) Henyey-Greenstein table of ``lut``^3 entries: gamma =
c pi / n, alpha = a pi / n, beta = b pi / n, cos theta = sin a sin b +
cos gamma cos a cos b, HG = (1 - g^2) / (4 pi (1 + g^2 - 2 g cos theta)^1.5)."""

from __future__ import annotations

import math
from typing import Dict

import torch


def make(spec: Dict, emission: torch.Tensor, device) -> torch.Tensor:
    return hg_lut(spec["lut"], spec["g"], device)


def hg_lut(n: int, g: float, device) -> torch.Tensor:
    ang = torch.arange(n, dtype=torch.float64, device=device) * (math.pi / n)
    gam, alp, bet = ang[:, None, None], ang[None, :, None], ang[None, None, :]
    cos_t = torch.sin(alp) * torch.sin(bet) + torch.cos(gam) * torch.cos(alp) * torch.cos(bet)
    hg = (1 - g * g) / (4 * math.pi * (1 + g * g - 2 * g * cos_t) ** 1.5)
    return hg.to(torch.float32).contiguous()
