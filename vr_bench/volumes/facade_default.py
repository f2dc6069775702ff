"""The facade's default volume: 1 x 1 x 1, of value 1."""

from __future__ import annotations

from typing import Dict

import torch


def make(spec: Dict, emission: torch.Tensor, device) -> torch.Tensor:
    return torch.ones((1, 1, 1), dtype=torch.float32, device=device)
