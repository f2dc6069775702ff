"""Camera ray generation and ray-box intersection (port of
``volume_renderer_tpu.ops.geometry``).

- Ray generation:
    u = (x / W) * 2 - 1
    ratio = H / W
    v = (y / H) * 2 * ratio - ratio
    origin = cameraXOffset * xVec - objectDistance * zVec
    dir = normalize(u * normalize(xVec) + v * yVec + focalLength * zVec)
  Only xVec is re-normalized, as in the reference kernel.
- Slab-method AABB intersection with the reference's sign-indexed branch
  cascade, so the hit predicate matches bitwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch.ops.float3 import F3, div_scalar, normalize


def generate_rays(
    width: int,
    height: int,
    x_vec: F3,
    y_vec: F3,
    z_vec: F3,
    camera_x_offset,
    focal_length,
    object_distance,
    pixel_x: torch.Tensor,
    pixel_y: torch.Tensor,
) -> Tuple[F3, F3]:
    """Eye rays for integer pixel coords (pixel_x, pixel_y), SoA.

    Returns (origin, direction); origin components are 0-d.
    """
    u = div_scalar(pixel_x.to(torch.float32), float(width)) * 2.0 - 1.0
    ratio = float(np.float32(height) / np.float32(width))
    v = div_scalar(pixel_y.to(torch.float32), float(height)) * 2.0 * ratio - 1.0 * ratio

    origin = camera_x_offset * x_vec + (-1.0 * object_distance) * z_vec

    xn = normalize(x_vec)
    direction = normalize(
        F3(
            u * xn.x + v * y_vec.x + focal_length * z_vec.x,
            u * xn.y + v * y_vec.y + focal_length * z_vec.y,
            u * xn.z + v * y_vec.z + focal_length * z_vec.z,
        )
    )
    return origin, direction


def intersect_box(
    origin: F3, direction: F3, boxmin: F3, boxmax: F3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab intersection; returns (hit, tnear, tfar)."""
    inv_x = torch.reciprocal(direction.x)
    inv_y = torch.reciprocal(direction.y)
    inv_z = torch.reciprocal(direction.z)

    # parameters[sign] selects boxmin when inv >= 0 else boxmax
    tx_lo = torch.where(inv_x < 0, boxmax.x, boxmin.x)
    tx_hi = torch.where(inv_x < 0, boxmin.x, boxmax.x)
    ty_lo = torch.where(inv_y < 0, boxmax.y, boxmin.y)
    ty_hi = torch.where(inv_y < 0, boxmin.y, boxmax.y)
    tz_lo = torch.where(inv_z < 0, boxmax.z, boxmin.z)
    tz_hi = torch.where(inv_z < 0, boxmin.z, boxmax.z)

    tmin = (tx_lo - origin.x) * inv_x
    tmax = (tx_hi - origin.x) * inv_x
    tymin = (ty_lo - origin.y) * inv_y
    tymax = (ty_hi - origin.y) * inv_y

    fail1 = (tmin > tymax) | (tymin > tmax)

    tmin = torch.where(tymin > tmin, tymin, tmin)
    tmax = torch.where(tymax < tmax, tymax, tmax)

    tzmin = (tz_lo - origin.z) * inv_z
    tzmax = (tz_hi - origin.z) * inv_z

    fail2 = (tmin > tzmax) | (tzmin > tmax)

    tmin = torch.where(tzmin > tmin, tzmin, tmin)
    tmax = torch.where(tzmax < tmax, tzmax, tmax)

    hit = torch.logical_not(fail1 | fail2)
    return hit, tmin, tmax
