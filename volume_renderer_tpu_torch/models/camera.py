"""Camera (port of ``volume_renderer_tpu.models.camera``).

The kernel's xVector/yVector/zVector are the COLUMNS of the user's
rotation matrix; ``basis()`` returns them.

``key()`` says which camera a render was made for (the z-brick path's entry
record carries it). The rotation lives on the render's device; where it
was built on the host (``create`` from an array, ``rotate``) the camera
keeps its nine values as Python floats too, so that the key needs no
device-to-host copy, which would stall the stream.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike, as_float32, resolve_device
from volume_renderer_tpu_torch.ops.float3 import F3


@dataclass(frozen=True, eq=False)
class Camera:
    rotation: torch.Tensor  # (3, 3) float32; columns are xVec, yVec, zVec
    focal_length: float = 0.0
    distance_to_object: float = 0.0
    # the rotation's values, row-major, where the host had them; else None
    rotation_host: Optional[Tuple[float, ...]] = dataclasses.field(default=None, repr=False)

    @classmethod
    def create(cls, rotation=None, focal_length: float = 0.0,
               distance_to_object: float = 0.0, device: DeviceLike = None) -> "Camera":
        dev = resolve_device(device)
        if rotation is None:
            rotation = np.eye(3, dtype=np.float32)
        if isinstance(rotation, torch.Tensor):
            on_host = rotation.device.type == "cpu"
            if on_host:  # a copy: the caller's tensor may change, the key must not
                rotation = rotation.clone()
            host = _host_values(rotation.detach().numpy()) if on_host else None
        else:
            host = _host_values(np.asarray(rotation, np.float32))
        return cls(
            rotation=as_float32(rotation, dev),
            focal_length=float(focal_length),
            distance_to_object=float(distance_to_object),
            rotation_host=host,
        )

    def replace(self, **changes) -> "Camera":
        """A copy with ``changes``; a new rotation drops the host values
        unless ``rotation_host`` comes with it."""
        if "rotation" in changes and "rotation_host" not in changes:
            changes["rotation_host"] = None
        return dataclasses.replace(self, **changes)

    def to(self, device: torch.device) -> "Camera":
        """The same camera with its rotation on ``device``."""
        return dataclasses.replace(self, rotation=self.rotation.to(device))

    def key(self) -> Tuple[float, ...]:
        """The camera as eleven floats: the rotation row-major, the focal
        length and the distance to the object. From the host values where
        the camera has them, else read from the device."""
        rotation = self.rotation_host
        if rotation is None:
            rotation = _host_values(self.rotation.detach().cpu().numpy())
        return rotation + (float(self.focal_length), float(self.distance_to_object))

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
        return self.replace(rotation=torch.tensor(rotated, device=self.rotation.device),
                            rotation_host=_host_values(rotated))


def _host_values(rotation: np.ndarray) -> Tuple[float, ...]:
    return tuple(float(v) for v in np.asarray(rotation, np.float32).reshape(-1))


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
