"""Batched forward ray-march in plain PyTorch (port of
``volume_renderer_tpu.ops.forward``).

All rays advance together in lock-step; per-ray early termination (opacity
threshold / box exit) is an active mask, and the march stops once every
ray has terminated or after ``opts.n_steps`` steps. Inactive rays
contribute exactly zero, so this is the reference's per-ray break.

This is the plain version of the march kernel (``ops/cuda_march.py``):
the same per-ray arithmetic, with positions and t advanced by repeated
accumulation (``pos += step``, ``t += tstep``). It runs on any device and
is the CPU path of ``render_forward_fast``.

``differentiable=True`` runs the fixed trip count ``opts.n_steps`` with the
same masks and the same values; the march updates nothing of the graph in
place, so plain ``torch.autograd`` goes through it. It keeps every step's
tensors alive for the backward: it is the gradient oracle of the replay
backward (``ops/vjp.py``), for small scenes only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.float3 import F3
from volume_renderer_tpu_torch.ops.geometry import generate_rays, intersect_box


def _init_rays(scene: Scene, opts: RenderOptions, camera_x_offset, y_offset: int, n_rows: int):
    """Flattened (R,) ray state; r = y * W + x so reshape(rows, W) is the band."""
    consts = core.make_consts(scene, opts)
    dev = scene.device
    x_vec, y_vec, z_vec = scene.camera.basis()
    focal = float(np.float32(scene.camera.focal_length))
    dist = float(np.float32(scene.camera.distance_to_object))
    cam_off = float(np.float32(camera_x_offset))

    r = torch.arange(opts.width * n_rows, dtype=torch.int64, device=dev)
    px = r % opts.width
    py = r // opts.width + int(y_offset)

    origin, direction = generate_rays(
        opts.width, opts.height, x_vec, y_vec, z_vec, cam_off, focal, dist, px, py
    )
    boxmin = F3(*(torch.tensor(v, dtype=torch.float32, device=dev) for v in consts.boxmin))
    boxmax = F3(*(torch.tensor(v, dtype=torch.float32, device=dev) for v in consts.boxmax))
    hit, tnear, tfar = intersect_box(origin, direction, boxmin, boxmax)
    tnear = torch.clamp_min(tnear, 0.0)
    tnear = torch.where(hit, tnear, 0.0)
    tfar = torch.where(hit, tfar, -1.0)

    pos0 = F3(origin.x + direction.x * tnear, origin.y + direction.y * tnear,
              origin.z + direction.z * tnear)
    step = direction * consts.tstep
    return consts, origin, pos0, step, tnear, tfar, hit


def render_rows(
    scene: Scene,
    opts: RenderOptions,
    camera_x_offset: float,
    y_offset: int,
    n_rows: int,
    steps: Optional[torch.Tensor] = None,
    differentiable: bool = False,
) -> torch.Tensor:
    """March a band of ``n_rows`` image rows starting at ``y_offset``.

    Returns (n_rows, W, 3). If ``steps`` (int32, (n_rows, W)) is given, it
    receives each ray's number of composited samples. ``differentiable``:
    the fixed trip count, for ``torch.autograd`` (see the module docstring).
    """
    consts, origin, pos, step, t, tfar, active = _init_rays(
        scene, opts, camera_x_offset, y_offset, n_rows
    )
    samplers = core.make_samplers(scene)
    zeros = torch.zeros_like(t)
    sum_rgb, sum_w = F3(zeros, zeros, zeros), zeros
    count = torch.zeros_like(t, dtype=torch.int32)

    i = 0
    while i < opts.n_steps and (differentiable or bool(active.any())):
        shaded_rgb, alpha = core.march_step(scene, consts, pos, origin, samplers)
        new_rgb, new_w = core.composite_under(sum_rgb, sum_w, shaded_rgb, alpha)
        sum_rgb = F3(torch.where(active, new_rgb.x, sum_rgb.x),
                     torch.where(active, new_rgb.y, sum_rgb.y),
                     torch.where(active, new_rgb.z, sum_rgb.z))
        sum_w = torch.where(active, new_w, sum_w)
        count += active.to(torch.int32)

        t = t + consts.tstep
        active = active & (sum_w <= consts.opacity_threshold) & (t <= tfar)
        pos = pos + step
        i += 1

    if steps is not None:
        steps.copy_(count.reshape(n_rows, opts.width))
    return torch.stack([c.reshape(n_rows, opts.width) for c in sum_rgb], dim=-1)


def render_forward(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0,
                   differentiable: bool = False) -> torch.Tensor:
    """Batched forward render on the scene's device. Returns (H, W, 3) float32."""
    return render_rows(scene, opts, camera_x_offset, 0, opts.height,
                       differentiable=differentiable)
