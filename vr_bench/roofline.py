"""The yardstick of the kernels' roofline shares: the published peaks, the
float32 operations of one march step and one backward step, the bytes a
kernel must move, and the samples the rays need, counted by the
benchmark's own walk (never read from the kernel).

The operation counts are ``chip_smoke.py``'s (``flops_per_step``,
``bwd_flops_per_step``), frozen here and extended to volumes of another
shape than emission: such a volume is fetched at corners of its own, a
trilinear fetch of 39 operations where a volume of emission's shape costs
the 7 lerps of a blend (21), and its scatter takes weights of its own
(15 more).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from vr_bench.reference import lit_march as ref

# NVIDIA H100 SXM, dense, at its full 700 W power limit (NVIDIA's data sheet)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# one axis's coordinate is 2 (sub, mul), its corner and weight 6 (mul, sub,
# floor, sub, 2 clamps), a lerp 3; a transcendental counts as one, index
# math as none
_AXIS_COORD, _AXIS_CORNER, _LERP = 2, 6, 3
_COORDS, _BLEND = 3 * _AXIS_COORD, 7 * _LERP
_FETCH = 3 * _AXIS_CORNER + _BLEND
_STEP_UNLIT = _COORDS + _FETCH + 2 + 4 + 6 + 10 + 1 + 2 + 3  # + composite, t, stop, pos
# the six emission taps half a voxel from the centre: a tap's coordinate and
# corner on its own axis and 27 lerps, then the three differences
_STEP_OTF_TAPS = 6 * (1 + _AXIS_COORD + _AXIS_CORNER) + 27 * _LERP + 6
_STEP_NORMAL = 11 + 1  # + factor_reflection * re
_STEP_PER_LIGHT = 3 + 3 + 3 * 23 + 22 + _FETCH + 1 + 9

_CORNER_WEIGHTS, _X_WEIGHTS, _SCATTER = 3 + 4, 8, 8 + 8
_OWN_WEIGHTS = _CORNER_WEIGHTS + _X_WEIGHTS
_EM_TAPS_SCATTER = 9 + 7 + 6 + 4 * 10 + 4 * 3 + 20
_BWD_STEP = 99
_BWD_PER_LIGHT = 145
_BWD_PER_LIGHT_CHAIN = 26 + 1 + 3 * (54 + 2) + 10 + 30
_BWD_D_GRADIENT = 20
_BWD_NORMAL = 12 + 1 + 3 + 5 + 6 + 2


def _read(shape_like_emission: bool) -> int:
    """A volume fetched at the sample: a blend at emission's corners, or a
    fetch of its own."""
    return _BLEND if shape_like_emission else _FETCH


def fwd_flops_per_sample(lit: bool, lookup: bool, ab_same: bool, re_same: bool,
                         grads_same: bool, n_lights: int) -> int:
    """Operations of one forward step (absorption and reflection separate
    volumes, ``*_same``: of emission's shape)."""
    ops = _STEP_UNLIT + _read(ab_same)
    if lit:
        ops += _read(re_same) + _STEP_NORMAL + 3 + n_lights * _STEP_PER_LIGHT
        ops += 3 * _read(grads_same) if lookup else _STEP_OTF_TAPS
    return ops


def bwd_flops_per_sample(lookup: bool, ab_same: bool, re_same: bool, grads_same: bool,
                         n_lights: int) -> int:
    """Operations of one lit scatter step (K6, K6L): the replayed step with
    the cotangents, the scatters of emission (its taps, or the gradient
    volumes), absorption and reflection."""
    ops = _BWD_STEP + _read(ab_same) + _read(re_same)
    ops += (3 * _read(grads_same) if lookup else _STEP_OTF_TAPS) + _BWD_NORMAL
    ops += n_lights * (_BWD_PER_LIGHT + _BWD_PER_LIGHT_CHAIN)
    ops += 7 + 1 + _CORNER_WEIGHTS + _X_WEIGHTS + _BWD_D_GRADIENT + 1
    ops += (4 * _SCATTER if lookup else _EM_TAPS_SCATTER)
    if lookup and not grads_same:
        ops += 3 * _OWN_WEIGHTS
    for same in (ab_same, re_same):
        ops += _SCATTER + (0 if same else _OWN_WEIGHTS)
    return ops


def least_seconds(flops: float, nbytes: float) -> Dict:
    """The least time on the published peaks, and which bound sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"seconds": max(t_ops, t_bytes),
            "bound": "operations" if t_ops >= t_bytes else "bytes"}


def volume_bytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@torch.no_grad()
def count_samples(scene: ref.RefScene, chunk_samples: int = 1 << 24) -> int:
    """The samples the march composites over the whole image of ``scene``:
    for each ray the steps until ``t`` leaves the box or the opacity passes
    the threshold. Where even the densest absorption could not take a ray's
    opacity past the threshold inside the box, its count is the box's;
    only the other rays are walked."""
    dev = scene.emission.device
    c = ref.consts(tuple(scene.emission.shape[:3]), scene.element_size_um)
    pixels = torch.arange(scene.width * scene.height, device=dev)
    r = ref.rays(scene, c, pixels, torch.float64)
    n = r.n_geo.clone()
    densest = float(scene.factor_absorption) * float(scene.absorption.max())
    reach = 1.0 - torch.exp(-densest * c.tstep * n.to(torch.float64))
    walk = torch.nonzero(reach > scene.opacity_threshold).flatten()
    if walk.numel():
        sub = ref.Rays(pixels=r.pixels[walk], origin=r.origin, pos0=r.pos0[walk],
                       step=r.step[walk], n_geo=r.n_geo[walk])
        bmin = torch.tensor(c.boxmin, dtype=torch.float64, device=dev)
        scale = 1.0 / (torch.tensor(c.boxmax, dtype=torch.float64, device=dev) - bmin)
        ab = scene.absorption.to(torch.float64)
        for sel, length in ref._chunks(sub.n_geo, chunk_samples):
            k = torch.arange(length, device=dev, dtype=torch.float64)
            pos = sub.pos0[sel, None, :] + k[None, :, None] * sub.step[sel, None, :]
            alpha = 1.0 - torch.exp(-float(scene.factor_absorption)
                                    * ref.fetch(ab, (pos - bmin) * scale) * c.tstep)
            inside = torch.arange(length, device=dev)[None, :] < sub.n_geo[sel, None]
            opacity = 1.0 - torch.cumprod(1.0 - torch.where(inside, alpha, 0.0), dim=1)
            # sample k + 1 is taken while the opacity after k is at or below it
            past = (opacity > scene.opacity_threshold) & inside
            first = torch.where(past.any(dim=1), past.to(torch.int8).argmax(dim=1) + 1,
                                sub.n_geo[sel])
            n[walk[sel]] = torch.minimum(first, sub.n_geo[sel])
    return int(n.sum())


def share_pct(least_s: float, device_s: float):
    """100 times the least time over the kernel's device time; None where the
    trace saw no such kernel."""
    if device_s <= 0 or not math.isfinite(device_s):
        return None
    return 100.0 * least_s / device_s
