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


def corner_indices(shape_dhw: Tuple[int, int, int], i0: F3, i1: F3) -> Tuple[torch.Tensor, ...]:
    """Flat indices of the 8 corners, in the order c000, c100, c010, c110,
    c001, c101, c011, c111 (the digits are the x, y, z corner)."""
    _, h, w = shape_dhw
    stride_y = w
    stride_z = w * h
    return tuple(ix + iy * stride_y + iz * stride_z
                 for iz in (i0.z, i1.z) for iy in (i0.y, i1.y) for ix in (i0.x, i1.x))


def _blend(flat: torch.Tensor, idx, fx, fy, fz, dims_dhw, with_grad: bool):
    """Blends the 8 corner texels ``flat[idx]``: x, then y, then z (the GPU
    filtering order); with the coordinate derivatives if asked."""
    d, h, w = dims_dhw
    c000, c100, c010, c110, c001, c101, c011, c111 = (flat[i] for i in idx)

    c00 = c000 + fx * (c100 - c000)
    c10 = c010 + fx * (c110 - c010)
    c01 = c001 + fx * (c101 - c001)
    c11 = c011 + fx * (c111 - c011)

    c0 = c00 + fy * (c10 - c00)
    c1 = c01 + fy * (c11 - c01)

    value = c0 + fz * (c1 - c0)
    if not with_grad:
        return value
    dx0 = (c100 - c000) + fy * ((c110 - c010) - (c100 - c000))
    dx1 = (c101 - c001) + fy * ((c111 - c011) - (c101 - c001))
    d_dx = (dx0 + fz * (dx1 - dx0)) * float(w)
    dy0, dy1 = c10 - c00, c11 - c01
    d_dy = (dy0 + fz * (dy1 - dy0)) * float(h)
    d_dz = (c1 - c0) * float(d)
    return value, d_dx, d_dy, d_dz


def sample_trilinear(volume: torch.Tensor, coords: F3, with_grad: bool = False):
    """Trilinear sample of ``volume`` (D, H, W) at normalized coords (x, y, z).

    ``with_grad=True`` returns (value, d/dx, d/dy, d/dz): the derivatives
    with respect to the coordinates, from the same corner fetches (the lerp
    differences times the axis length, since u = c * N - 0.5). A clamped
    corner pair is one texel twice, so the derivative vanishes at an edge.
    """
    d, h, w = volume.shape
    i0, i1, fx, fy, fz = trilinear_setup((d, h, w), coords)
    idx = corner_indices((d, h, w), i0, i1)
    return _blend(volume.reshape(-1), idx, fx, fy, fz, (d, h, w), with_grad)


def zslab_corner_indices(slab_shape_dhw: Tuple[int, int, int], z_offset: int, full_d: int,
                         coords: F3):
    """Corner indices into a z-slab and the weights, for a fetch at GLOBAL
    normalized coords: the z corners are clamped against the full depth
    ``full_d`` first, exactly as ``trilinear_setup`` on the full volume
    clamps them, then shifted by ``z_offset`` into the slab (and clamped to
    it, so that no index leaves the slab whatever the coords).
    Returns (flat indices in ``corner_indices`` order, fx, fy, fz).
    """
    slab_d, h, w = slab_shape_dhw
    i0, i1, fx, fy, fz = trilinear_setup((full_d, h, w), coords)
    z0 = torch.clamp(i0.z - int(z_offset), 0, slab_d - 1)
    z1 = torch.clamp(i1.z - int(z_offset), 0, slab_d - 1)
    idx = corner_indices((slab_d, h, w), F3(i0.x, i0.y, z0), F3(i1.x, i1.y, z1))
    return idx, fx, fy, fz


def sample_trilinear_zslab(slab: torch.Tensor, coords: F3, z_offset: int, full_d: int):
    """Trilinear sample from a z-slab of a (full_d, H, W) volume.

    ``slab`` holds rows [z_offset, z_offset + slab_d) of the full volume,
    halo rows included. ``coords`` are global normalized coords; the values
    equal ``sample_trilinear`` on the full array as long as every z row the
    fetch touches lies inside the slab (the caller packs enough halo).
    The sampling primitive of the z-brick path (``parallel/bricks.py``).
    """
    slab_d, h, w = slab.shape
    idx, fx, fy, fz = zslab_corner_indices((slab_d, h, w), z_offset, full_d, coords)
    return _blend(slab.reshape(-1), idx, fx, fy, fz, (full_d, h, w), False)
