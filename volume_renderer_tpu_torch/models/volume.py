"""Volume container (port of ``volume_renderer_tpu.models.volume``).

Data layout: C-order (D, H, W) == (z, y, x), x fastest, float32, on one
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from volume_renderer_tpu_torch._device import DeviceLike, as_float32, resolve_device


@dataclass(frozen=True, eq=False)
class Volume:
    """Volumetric data + physical voxel size.

    data: float32 tensor, shape (D, H, W) = (z, y, x).
    element_size_um: (sx, sy, sz) physical voxel extent in micrometers.
    """

    data: torch.Tensor
    element_size_um: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @classmethod
    def create(cls, data, element_size_um=(1.0, 1.0, 1.0), device: DeviceLike = None) -> "Volume":
        """``data`` (array-like or tensor) as a float32 volume on ``device``
        (default: the CUDA card; raises when there is none)."""
        arr = as_float32(data, resolve_device(device))
        if arr.ndim == 2:
            arr = arr[None, :, :]
        if arr.ndim != 3:
            raise ValueError(f"Volume data must be 2D or 3D, got shape {tuple(arr.shape)}")
        return cls(data=arr.contiguous(), element_size_um=tuple(float(e) for e in element_size_um))

    def replace(self, **changes) -> "Volume":
        return dataclasses.replace(self, **changes)

    @property
    def shape_dhw(self) -> Tuple[int, int, int]:
        return tuple(self.data.shape)

    @property
    def extent_xyz(self) -> Tuple[int, int, int]:
        """(width, height, depth) — the reference's cudaExtent order."""
        d, h, w = self.data.shape
        return (w, h, d)

    def pad(self, padding: int, value: float = 0.0) -> "Volume":
        """Pad all three axes by ``padding`` on both sides."""
        p = int(padding)
        return self.replace(data=F.pad(self.data, (p,) * 6, value=value))

    def mip(self) -> torch.Tensor:
        """Maximum intensity projection along z -> (H, W) image."""
        return torch.amax(self.data, dim=0)

    def mean(self) -> torch.Tensor:
        return torch.mean(self.data)

    def max(self) -> torch.Tensor:
        return torch.max(self.data)

    def min(self) -> torch.Tensor:
        return torch.min(self.data)

    def normalize(self, new_min: float = 0.0, new_max: float = 1.0) -> "Volume":
        """Linear rescale to [new_min, new_max]."""
        mx = torch.max(self.data)
        mn = torch.min(self.data)
        out = (self.data - mn) * (new_max - new_min) / (mx - mn) + new_min
        return self.replace(data=out)

    def gradient_volumes(self) -> Tuple["Volume", "Volume", "Volume"]:
        """Central-difference gradients along the texture x, y, z axes,
        numpy-``gradient`` semantics: interior (f[i+1] - f[i-1]) * 0.5,
        one-sided f[1] - f[0] / f[-1] - f[-2] at the edges.
        Returns (d/dx, d/dy, d/dz) as Volumes."""
        gz, gy, gx = (_gradient_along(self.data, axis) for axis in range(3))
        return (self.replace(data=gx), self.replace(data=gy), self.replace(data=gz))

    def grad_matlab(self) -> Tuple["Volume", "Volume", "Volume"]:
        """MATLAB ``[gx, gy, gz] = gradient(Data)`` ordering: the first two
        outputs swap the texture x and y axes (reference example parity)."""
        gx, gy, gz = self.gradient_volumes()
        return (gy, gx, gz)


def _gradient_along(a: torch.Tensor, axis: int) -> torch.Tensor:
    n = a.shape[axis]
    if n < 2:
        raise ValueError("a numerical gradient needs at least 2 elements along every axis")
    upper = a.narrow(axis, 1, 1) - a.narrow(axis, 0, 1)
    lower = a.narrow(axis, n - 1, 1) - a.narrow(axis, n - 2, 1)
    inner = (a.narrow(axis, 2, n - 2) - a.narrow(axis, 0, n - 2)) * 0.5
    return torch.cat((upper, inner, lower), dim=axis).contiguous()
