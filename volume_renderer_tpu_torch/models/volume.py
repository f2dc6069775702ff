"""Volume container (port of ``volume_renderer_tpu.models.volume``).

Data layout: C-order (D, H, W) == (z, y, x), x fastest, float32, on one
device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Tuple, Union

import numpy as np
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

    def resize(self, newsize: Union[float, Tuple[int, int, int]],
               method: str = "cubic") -> "Volume":
        """The volume resampled to a new shape, as ``jax.image.resize`` does
        (the reference's imresize3, Volume.m:93-105).

        ``newsize``: a scale factor (each axis ``max(1, round(n * f))``) or
        an explicit (D, H, W). ``method``: "cubic" (Keys, a = -0.5; also
        "bicubic", "tricubic"), "linear" (also "bilinear", "trilinear",
        "triangle"), "lanczos3", "lanczos5" or "nearest". Each axis whose
        length changes gets one (in, out) weight matrix: half-pixel
        centres, the kernel widened by 1 / scale where the axis shrinks
        (``jax.image.resize``'s antialias), each column renormalised and
        zero for a sample outside the input; the three are applied as
        contractions on the volume's device.
        """
        if isinstance(newsize, (int, float)):
            shape = tuple(max(1, int(round(n * newsize))) for n in self.data.shape)
        else:
            shape = tuple(int(n) for n in newsize)
        if len(shape) != 3:
            raise ValueError(f"resize needs a (D, H, W) shape, got {shape}")
        return self.replace(data=resize_array(self.data, shape, method))

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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


def _lanczos(radius: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def kernel(x):
        y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, np.pi ** 2 * x * x, 1.0), 1.0)
        return torch.where(x > radius, 0.0, out)
    return kernel


RESIZE_KERNELS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), _keys_cubic),
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"), _triangle),
    "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0),
}


def resize_weights(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """The (n_in, n_out) float32 weights of one axis, as
    ``jax.image.resize`` computes them (its ``compute_weight_mat``)."""
    inv_scale = float(np.float32(1.0 / (n_out / n_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                                 device=device)[:, None]) / kernel_scale
    weights = kernel(x)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_array(data: torch.Tensor, shape: Tuple[int, int, int], method: str) -> torch.Tensor:
    """``data`` (D, H, W) resampled to ``shape`` (see ``Volume.resize``)."""
    data = data.to(torch.float32)
    if method == "nearest":
        for axis, (m, n) in enumerate(zip(data.shape, shape)):
            if m != n:
                pick = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n)
                data = data.index_select(axis, pick.to(torch.int64).to(data.device))
        return data.contiguous()
    if method not in RESIZE_KERNELS:
        raise ValueError(f"unknown resize method {method!r}: one of "
                         f"{sorted(RESIZE_KERNELS) + ['nearest']}")
    kernel = RESIZE_KERNELS[method]
    for axis, (m, n) in enumerate(zip(data.shape, shape)):
        if m != n:
            w = resize_weights(m, n, kernel, data.device)
            data = torch.movedim(torch.tensordot(data, w, dims=([axis], [0])), -1, axis)
    return data.contiguous()
