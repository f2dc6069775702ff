"""Camera (port of ``volume_renderer_tpu.models.camera``).

The kernel's xVector/yVector/zVector are the COLUMNS of the user's
rotation matrix; ``basis()`` returns them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike, as_float32, resolve_device
from volume_renderer_tpu_torch.ops.float3 import F3


@dataclass(frozen=True, eq=False)
class Camera:
    rotation: torch.Tensor  # (3, 3) float32; columns are xVec, yVec, zVec
    focal_length: float = 0.0
    distance_to_object: float = 0.0

    @classmethod
    def create(cls, rotation=None, focal_length: float = 0.0,
               distance_to_object: float = 0.0, device: DeviceLike = None) -> "Camera":
        dev = resolve_device(device)
        if rotation is None:
            rotation = np.eye(3, dtype=np.float32)
        return cls(
            rotation=as_float32(rotation, dev),
            focal_length=float(focal_length),
            distance_to_object=float(distance_to_object),
        )

    def replace(self, **changes) -> "Camera":
        return dataclasses.replace(self, **changes)

    def basis(self) -> Tuple[F3, F3, F3]:
        """(x_vec, y_vec, z_vec) as 0-d F3s — columns of the rotation."""
        m = self.rotation
        return (
            F3(m[0, 0], m[1, 0], m[2, 0]),
            F3(m[0, 1], m[1, 1], m[2, 1]),
            F3(m[0, 2], m[1, 2], m[2, 2]),
        )

    def rotate(self, alpha_deg: float, beta_deg: float, gamma_deg: float) -> "Camera":
        """R <- R @ Rx(alpha) @ Ry(beta) @ Rz(gamma), angles in degrees.

        A 3x3 product, built on the host in float32: the radians are
        float32, their sines and cosines are rounded from float64, and each
        entry of a product accumulates a*b + s with one rounding per term
        (a fused multiply-add). This reproduces the JAX package's rotate on
        the CPU bit for bit.
        """
        m = self.rotation.detach().to("cpu", torch.float32).numpy()
        rotated = rotate_matrix(m, alpha_deg, beta_deg, gamma_deg)
        return self.replace(rotation=torch.tensor(rotated, device=self.rotation.device))


def _matmul_fma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros((3, 3), np.float32)
    for i in range(3):
        for j in range(3):
            s = 0.0
            for k in range(3):
                # the float64 product of two float32 values is exact
                s = float(np.float32(float(a[i, k]) * float(b[k, j]) + s))
            out[i, j] = s
    return out


def rotate_matrix(rotation: np.ndarray, alpha_deg: float, beta_deg: float,
                  gamma_deg: float) -> np.ndarray:
    """``rotation @ Rx(alpha) @ Ry(beta) @ Rz(gamma)`` in float32 (see
    ``Camera.rotate``)."""
    deg = np.float32(np.pi / 180.0)
    (ca, sa), (cb, sb), (cg, sg) = (
        (np.float32(np.cos(r)), np.float32(np.sin(r)))
        for r in (float(np.float32(v) * deg) for v in (alpha_deg, beta_deg, gamma_deg)))
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]], np.float32)
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]], np.float32)
    rz = np.array([[cg, -sg, 0], [sg, cg, 0], [0, 0, 1]], np.float32)
    m = np.asarray(rotation, np.float32)
    return _matmul_fma(_matmul_fma(_matmul_fma(m, rx), ry), rz)
