"""Structure-of-arrays 3-vector helpers (port of ``volume_renderer_tpu.ops.float3``).

All ray-march math runs on three separate component tensors (x, y, z), each
of shape (R,) or 0-d. ``F3`` is a thin NamedTuple so the math reads like
vector code. ``normalize`` is ``v * rsqrt(dot(v, v))``, defined as the zero
vector for zero-length inputs.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Scalar = Union[float, torch.Tensor]


class F3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o: "F3") -> "F3":
        return F3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "F3") -> "F3":
        return F3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o: Union["F3", Scalar]) -> "F3":
        if isinstance(o, F3):
            return F3(self.x * o.x, self.y * o.y, self.z * o.z)
        return F3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self) -> "F3":
        return F3(-self.x, -self.y, -self.z)


def dot(a: F3, b: F3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def length(a: F3) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: F3) -> F3:
    """CUDA helper_math normalize: v * rsqrt(dot(v, v)), 0-safe."""
    d = dot(a, a)
    inv = torch.where(d > 0.0, torch.rsqrt(torch.where(d > 0.0, d, 1.0)), 0.0)
    return a * inv


def div_scalar(a: torch.Tensor, s: float) -> torch.Tensor:
    """Correctly rounded ``a / s``. PyTorch's CUDA division by a host scalar
    multiplies by its reciprocal instead, which rounds differently from the
    kernel's (and XLA's) true division."""
    return torch.div(a, torch.full_like(a, s))


def where3(c: torch.Tensor, a: F3, b: F3) -> F3:
    return F3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y), torch.where(c, a.z, b.z))
