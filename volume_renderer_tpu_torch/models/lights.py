"""Light sources (port of ``volume_renderer_tpu.models.lights``).

Positions are world-space (x, y, z).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device


class LightSource:
    """Position + color, both length-3."""

    def __init__(self, position, color):
        position = tuple(float(p) for p in position)
        color = tuple(float(c) for c in color)
        if len(position) != 3:
            raise ValueError("dimensions of position must be [1,3]")
        if len(color) != 3:
            raise ValueError("dimensions of color must be [1,3]")
        self.position = position
        self.color = color

    def __repr__(self):
        return f"LightSource(position={self.position}, color={self.color})"


def pack_lights(lights: Sequence[LightSource],
                device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack lights into (L, 3) float32 position and color tensors."""
    dev = resolve_device(device)
    pos = torch.tensor([l.position for l in lights], dtype=torch.float32, device=dev)
    col = torch.tensor([l.color for l in lights], dtype=torch.float32, device=dev)
    return pos.reshape(-1, 3), col.reshape(-1, 3)
