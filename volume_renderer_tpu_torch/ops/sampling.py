"""CUDA-texture-semantics trilinear sampling (port of
``volume_renderer_tpu.ops.sampling``).

Normalized coordinates, linear filtering, clamp addressing: the texel grid
is sampled at ``u = c * N - 0.5`` per axis and the 8 surrounding texels are
blended with full float32 weights (hardware texture units quantize them to
8 bits, which is why the kernel does not use them), x first, then y, then
z. Out-of-range texel indices clamp to [0, N-1].

Volumes are C-order (D, H, W) == (z, y, x), x fastest.
"""

from __future__ import annotations

from typing import Tuple

import torch

from volume_renderer_tpu_torch.ops.float3 import F3

# the float corner coordinate is clamped to [-1, N] before its cast to int
# (the kernel does the same): the clamped indices are unchanged, and no
# out-of-range float reaches the conversion


def _corner(u: torch.Tensor, n: int):
    f0 = torch.floor(u)
    i0 = torch.clamp(f0, -1.0, float(n)).to(torch.int64)
    return f0, torch.clamp(i0, 0, n - 1), torch.clamp(i0 + 1, 0, n - 1)


def trilinear_setup(shape_dhw: Tuple[int, int, int], coords: F3):
    """Corner indices and weights for a CUDA-style trilinear fetch.

    coords are normalized (x, y, z) in [0, 1] (values outside clamp).
    Returns (i0, i1, fx, fy, fz): i0/i1 are F3 of int64 clamped indices.
    """
    d, h, w = shape_dhw
    ux = coords.x * float(w) - 0.5
    uy = coords.y * float(h) - 0.5
    uz = coords.z * float(d) - 0.5

    fx0, ix0, ix1 = _corner(ux, w)
    fy0, iy0, iy1 = _corner(uy, h)
    fz0, iz0, iz1 = _corner(uz, d)

    return (F3(ix0, iy0, iz0), F3(ix1, iy1, iz1), ux - fx0, uy - fy0, uz - fz0)


def sample_trilinear(volume: torch.Tensor, coords: F3) -> torch.Tensor:
    """Trilinear sample of ``volume`` (D, H, W) at normalized coords (x, y, z)."""
    d, h, w = volume.shape
    i0, i1, fx, fy, fz = trilinear_setup((d, h, w), coords)

    flat = volume.reshape(-1)
    stride_y = w
    stride_z = w * h

    def fetch(ix, iy, iz):
        return flat[ix + iy * stride_y + iz * stride_z]

    c000 = fetch(i0.x, i0.y, i0.z)
    c100 = fetch(i1.x, i0.y, i0.z)
    c010 = fetch(i0.x, i1.y, i0.z)
    c110 = fetch(i1.x, i1.y, i0.z)
    c001 = fetch(i0.x, i0.y, i1.z)
    c101 = fetch(i1.x, i0.y, i1.z)
    c011 = fetch(i0.x, i1.y, i1.z)
    c111 = fetch(i1.x, i1.y, i1.z)

    # blend x, then y, then z (the GPU filtering order)
    c00 = c000 + fx * (c100 - c000)
    c10 = c010 + fx * (c110 - c010)
    c01 = c001 + fx * (c101 - c001)
    c11 = c011 + fx * (c111 - c011)

    c0 = c00 + fy * (c10 - c00)
    c1 = c01 + fy * (c11 - c01)

    return c0 + fz * (c1 - c0)
