"""Inverse volume rendering: training steps on one device (port of the
single-device part of ``volume_renderer_tpu.train``).

The workload is scene reconstruction: fit voxel grids and transfer
parameters so that the rendered image matches a target view. Parameters are
a dict of leaf tensors (``split_params``), the optimizer is a
``torch.optim.Optimizer`` over them, and a step updates them in place and
returns the loss.

``train_step`` differentiates ``band_loss`` with ``torch.autograd``
(``ops.vjp.render_fused``: plain PyTorch forward and replay backward, any
loss could take its place). ``train_step_fast`` is the production step for
the sum-of-squares loss: the forward kernel, the closed-form pixel
cotangent, the backward kernel, the optimizer; on a CPU scene the same
calls run the kernels' plain versions. ``train_step_sharded`` is
``train_step`` with the image rows cut into bands over a device list
(rays-DP); ``parallel.pallas_dp.train_step_fast_sharded`` is its kernel
step.

For volumes larger than a device: ``train_step_slabbed`` differentiates the
z-slab sweep, ``train_step_streamed`` keeps the grids in host memory and
streams them a slab at a time (``ops/slab.py``, ``ops/cuda_slab.py``), and
``train_step_planned`` lets the memory planner (``api/planner.py``) pick
the tier for a step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.cuda_march import lookup_pack, render_rows_fast
from volume_renderer_tpu_torch.ops.forward import render_rows
from volume_renderer_tpu_torch.ops.vjp import render_fused
from volume_renderer_tpu_torch.parallel.mesh import check_mesh
from volume_renderer_tpu_torch.parallel.sharding import scenes_on
from volume_renderer_tpu_torch.utils.profiling import span

Params = Dict[str, torch.Tensor]


def split_params(scene: Scene) -> Tuple[Params, Scene]:
    """``scene`` as (trainable parameters, the scene they go back into).

    Trainable: the emission grid, the absorption grid unless aliased, the
    three transfer factors and the color. Each is a fresh leaf tensor that
    requires grad, so an optimizer can take ``params.values()`` and the
    scene's own tensors stay as they are.
    """
    s = scene.settings
    params = {
        "emission": scene.emission.data,
        "factor_emission": s.factor_emission,
        "factor_absorption": s.factor_absorption,
        "factor_reflection": s.factor_reflection,
        "color": s.color,
    }
    if not scene.absorption_aliased:
        params["absorption"] = scene.absorption.data
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}, scene


def merge_params(params: Params, scene: Scene) -> Scene:
    """``scene`` with ``params`` in place of its own leaves."""
    settings = dataclasses.replace(
        scene.settings,
        factor_emission=params["factor_emission"],
        factor_absorption=params["factor_absorption"],
        factor_reflection=params["factor_reflection"],
        color=params["color"],
    )
    kwargs = dict(emission=scene.emission.replace(data=params["emission"]), settings=settings)
    if "absorption" in params:
        kwargs["absorption"] = scene.absorption.replace(data=params["absorption"])
    return scene.replace(**kwargs)


def band_loss(
    params: Params,
    scene: Scene,
    opts: RenderOptions,
    target_band: torch.Tensor,
    y_offset: int,
    n_rows: int,
    camera_x_offset: float = 0.0,
    impl: str = "fused",
    early_exit: bool = True,
) -> torch.Tensor:
    """Sum of squared errors of one image band (a sum, not a mean, so that
    the bands' losses add up to the image's).

    impl="fused": ``render_fused``, the replay backward, memory independent
        of the march length.
    impl="scan": the ``differentiable=True`` march and plain autograd, the
        gradient oracle; memory grows with the march length, small scenes
        only.
    """
    merged = merge_params(params, scene)
    if impl == "fused":
        band = render_fused(merged, opts, camera_x_offset, y_offset, n_rows,
                            early_exit=early_exit)
    elif impl == "scan":
        band = render_rows(merged, opts, camera_x_offset, y_offset, n_rows, differentiable=True)
    else:
        raise ValueError(f"impl must be 'fused' or 'scan', got {impl!r}")
    return torch.sum((band - target_band) ** 2)


def train_step(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
               opts: RenderOptions, target: torch.Tensor) -> torch.Tensor:
    """One training step on the whole image through ``torch.autograd``;
    updates ``params`` in place and returns the loss before the update."""
    optimizer.zero_grad(set_to_none=True)
    loss = band_loss(params, scene, opts, target, 0, opts.height)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_step_sharded(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                       opts: RenderOptions, target: torch.Tensor, *,
                       mesh: Sequence[torch.device]) -> torch.Tensor:
    """``train_step`` with the rays cut into bands over ``mesh``: band i, rows
    [i * H / n, (i + 1) * H / n), is ``band_loss`` on ``mesh[i]`` (the
    parameters copied there inside autograd's graph) with the fixed trip
    count (``early_exit=False``, equal work on every device); the band
    losses are summed on ``mesh[0]`` and one backward and one optimizer
    step follow. ``H`` must be divisible by the mesh size. Updates
    ``params`` in place and returns the loss before the update."""
    mesh = check_mesh(mesh, "band")
    n = len(mesh)
    if opts.height % n != 0:
        raise ValueError(f"image height {opts.height} must be divisible by mesh size {n}")
    rows = opts.height // n
    on = scenes_on(scene, mesh)
    target = target.to(torch.float32)
    optimizer.zero_grad(set_to_none=True)
    losses = []
    for i, dev in enumerate(mesh):
        band_params = {k: v.to(dev) for k, v in params.items()}
        band_target = target[i * rows:(i + 1) * rows].to(dev)
        losses.append(band_loss(band_params, on[dev], opts, band_target, i * rows, rows,
                                early_exit=False).to(mesh[0]))
    loss = torch.stack(losses).sum()
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_step_fast(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                    opts: RenderOptions, target: torch.Tensor,
                    camera_x_offset: float = 0.0) -> torch.Tensor:
    """One training step at kernel speed; updates ``params`` in place and
    returns the loss before the update.

    The loss ``sum((img - target)**2)`` has the closed-form pixel cotangent
    ``2 * (img - target)``, so nothing is traced: forward kernel, backward
    kernel on its image (``voxel_grads_fast``), optimizer: K1 + K3 unlit,
    K4 + K6 lit with on-the-fly gradients, K5 + K6L lit with lookup gradient
    volumes (K5's pack made once for both). For other losses use
    ``train_step``.

    A lit loss feels the emission grid through the normals, differences of
    neighbouring voxels: keep the optimizer's step per voxel far below
    those differences, or the normals scramble and the loss rises (PERF.md).
    """
    with span("train.step"):
        with torch.no_grad():
            merged = merge_params(params, scene)
            packed = lookup_pack(merged)
            img = render_rows_fast(merged, opts, camera_x_offset, packed=packed)
            resid = img - target.to(torch.float32)
            loss = torch.sum(resid ** 2)
            _, grads = voxel_grads_fast(merged, opts, 2.0 * resid, camera_x_offset, image=img,
                                        packed=packed)
            for key, p in params.items():
                p.grad = grads[key].reshape(p.shape)
        with span("train.optimizer", device=True):
            optimizer.step()
        return loss


def train_step_streamed(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                        opts: RenderOptions, target: torch.Tensor, *, n_slabs: int,
                        device: DeviceLike = None) -> torch.Tensor:
    """One training step with the grids in host memory: the forward and the
    backward stream one halo-padded z-slab at a time to ``device`` (default:
    the card; ``ops.slab.streamed_grads`` with the sum-of-squares cotangent
    ``2 * (image - target)``), so that only the march's working set must fit
    it. The optimizer updates ``params`` wherever they live: grids held as
    CPU tensors (pinned, for fast copies) are updated in host memory. Returns
    the loss before the update, on ``device``."""
    from volume_renderer_tpu_torch.ops.slab import streamed_grads

    dev = resolve_device(device)
    with torch.no_grad():
        merged = merge_params(params, scene)
        tgt = target.to(dev, torch.float32)
        grads, image = streamed_grads(merged, opts, None, n_slabs=n_slabs,
                                      g_fn=lambda out: 2.0 * (out - tgt), device=dev)
        loss = torch.sum((image - tgt) ** 2)
        for key, p in params.items():
            p.grad = grads[key].to(p.device).reshape(p.shape)
    optimizer.step()
    return loss


def band_loss_slabbed(params: Params, scene: Scene, opts: RenderOptions, target: torch.Tensor,
                      n_slabs: int, camera_x_offset: float = 0.0) -> torch.Tensor:
    """Sum of squared errors of the whole image through the differentiable
    z-slab sweep: ``ops.slab.render_fused_slabbed`` (plain PyTorch) on a CPU
    scene, ``ops.cuda_slab.render_fused_slabbed_fast`` (the K7 launch forms)
    on a CUDA one."""
    from volume_renderer_tpu_torch.ops import cuda_slab, slab

    merged = merge_params(params, scene)
    fused = (cuda_slab.render_fused_slabbed_fast if merged.device.type == "cuda"
             else slab.render_fused_slabbed)
    img = fused(merged, opts, camera_x_offset, n_slabs=n_slabs)
    return torch.sum((img - target.to(img.device, torch.float32)) ** 2)


def train_step_slabbed(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                       opts: RenderOptions, target: torch.Tensor, *,
                       n_slabs: int) -> torch.Tensor:
    """One training step through the z-slab sweep (``band_loss_slabbed``);
    updates ``params`` in place and returns the loss before the update."""
    optimizer.zero_grad(set_to_none=True)
    loss = band_loss_slabbed(params, scene, opts, target, n_slabs)
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_step_planned(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                       opts: RenderOptions, target: torch.Tensor,
                       budget_bytes: Optional[int] = None, mesh=None,
                       device: DeviceLike = None):
    """A training step whose tier the memory planner picks
    (``api.planner.plan_render`` with ``training=True`` and this
    ``optimizer``), marching on ``device`` (default: the card): ``"cuda"``
    ``train_step_fast``, ``"plain"`` ``train_step``, ``"cuda_dp"``
    ``parallel.pallas_dp.train_step_fast_sharded`` and ``"bricked"``
    ``parallel.bricks.train_step_fast_bricked`` over ``mesh``, ``"slabbed"``
    ``train_step_slabbed`` and ``"streamed"`` ``train_step_streamed``. The
    streamed tier takes grids in host memory, every other tier grids on
    ``device``; a step whose grids are elsewhere raises ``ValueError``.
    Updates ``params`` in place and returns ``(loss, plan)``."""
    from volume_renderer_tpu_torch.api.planner import plan_render

    dev = resolve_device(device)
    merged = merge_params(params, scene)
    plan = plan_render(merged, opts, budget_bytes=budget_bytes, training=True, mesh=mesh,
                       optimizer=optimizer, device=dev)
    where = params["emission"].device
    want = torch.device("cpu") if plan.path == "streamed" else dev
    if where.type != want.type or (want.index is not None and where != want):
        raise ValueError(f"{plan}: the {plan.path} tier takes the grids on {want}, "
                         f"they are on {where}")
    if plan.path == "cuda_dp":
        from volume_renderer_tpu_torch.parallel.pallas_dp import train_step_fast_sharded

        loss = train_step_fast_sharded(params, optimizer, scene, opts, target, mesh=mesh)
    elif plan.path == "bricked":
        from volume_renderer_tpu_torch.parallel.bricks import train_step_fast_bricked

        loss = train_step_fast_bricked(params, optimizer, scene, opts, target, mesh=mesh)
    elif plan.path == "slabbed":
        loss = train_step_slabbed(params, optimizer, scene, opts, target, n_slabs=plan.n_slabs)
    elif plan.path == "streamed":
        loss = train_step_streamed(params, optimizer, scene, opts, target,
                                   n_slabs=plan.n_slabs, device=dev)
    elif plan.path == "cuda":
        loss = train_step_fast(params, optimizer, scene, opts, target)
    else:  # plain: the whole-grid step through torch.autograd
        loss = train_step(params, optimizer, scene, opts, target)
    return loss, plan
