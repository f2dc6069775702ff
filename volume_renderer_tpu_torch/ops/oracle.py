"""The reference renderer ("the oracle"; port of ``volume_renderer_tpu.ops.oracle``).

The correctness anchor: one ray per pixel with the break structure of the
reference kernel's march (``d_render``, volumeRender_kernel.cu:365-507):

    while (true) { composite;
                   if (sum.w > opacity_threshold) break;
                   t += tstep; if (t > tfar) break;
                   pos += step; }

so a ray that hits the box takes at least one step, positions advance by
repeated accumulation (pos += step), and the step that crosses the
threshold is composited. Pixel (x, y) lands at image[y, x].

The JAX package runs a while loop per pixel; here every pixel marches at
once, each with its own running flag, until no pixel runs. It has no step
cap: deliberately simple, and slower than ``render_forward``. A band of
image rows (``y_offset``, ``n_rows``) marches those pixels alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.float3 import F3
from volume_renderer_tpu_torch.ops.forward import _camera_scalar
from volume_renderer_tpu_torch.ops.geometry import generate_rays, intersect_box


@torch.no_grad()
def render_oracle(scene: Scene, opts: RenderOptions, camera_x_offset=0.0,
                  device: DeviceLike = None, y_offset: int = 0,
                  n_rows: Optional[int] = None) -> torch.Tensor:
    """Render with the per-pixel oracle on ``device`` (None: the CUDA card;
    the scene is moved there). Returns (H, W, 3) float32 there, or with
    ``n_rows`` the (n_rows, W, 3) band from image row ``y_offset``."""
    n_rows = opts.height if n_rows is None else int(n_rows)
    scene = scene.to(resolve_device(device))
    dev = scene.device
    consts = core.make_consts(scene, opts)
    samplers = core.make_samplers(scene)
    x_vec, y_vec, z_vec = scene.camera.basis()

    py, px = torch.meshgrid(torch.arange(int(y_offset), int(y_offset) + n_rows, device=dev),
                            torch.arange(opts.width, device=dev), indexing="ij")
    origin, direction = generate_rays(
        opts.width, opts.height, x_vec, y_vec, z_vec, _camera_scalar(camera_x_offset, dev),
        _camera_scalar(scene.camera.focal_length, dev),
        _camera_scalar(scene.camera.distance_to_object, dev), px.reshape(-1), py.reshape(-1))
    boxmin, boxmax = (F3(*(torch.tensor(v, dtype=torch.float32, device=dev) for v in box))
                      for box in (consts.boxmin, consts.boxmax))
    hit, tnear, tfar = intersect_box(origin, direction, boxmin, boxmax)
    # the missing pixels' positions stay finite; they never composite
    tnear = torch.where(hit, torch.clamp_min(tnear, 0.0), 0.0)
    tfar = torch.where(hit, tfar, -1.0)
    step = direction * consts.tstep
    pos = F3(origin.x + direction.x * tnear, origin.y + direction.y * tnear,
             origin.z + direction.z * tnear)

    zero = torch.zeros_like(tnear)
    sum_rgb, sum_w, t = F3(zero, zero, zero), zero, tnear
    running = hit
    while bool(running.any()):
        shaded, alpha = core.march_step(scene, consts, pos, origin, samplers)
        new_rgb, new_w = core.composite_under(sum_rgb, sum_w, shaded, alpha)
        sum_rgb = F3(*(torch.where(running, n, o) for n, o in zip(new_rgb, sum_rgb)))
        sum_w = torch.where(running, new_w, sum_w)
        t = t + consts.tstep
        running = running & (sum_w <= consts.opacity_threshold) & (t <= tfar)
        pos = pos + step
    return torch.stack([c.reshape(n_rows, opts.width) for c in sum_rgb], dim=-1)
