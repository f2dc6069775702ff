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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.ops.forward import render_rows
from volume_renderer_tpu_torch.ops.vjp import render_fused
from volume_renderer_tpu_torch.parallel.mesh import check_mesh
from volume_renderer_tpu_torch.parallel.sharding import scenes_on

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
    kernel on its image (``voxel_grads_fast``), optimizer. Lit scenes need
    on-the-fly gradients; for other losses use ``train_step``.

    A lit loss feels the emission grid through the normals, differences of
    neighbouring voxels: keep the optimizer's step per voxel far below
    those differences, or the normals scramble and the loss rises (PERF.md).
    """
    with torch.no_grad():
        merged = merge_params(params, scene)
        img = render_forward_fast(merged, opts, camera_x_offset)
        resid = img - target.to(torch.float32)
        loss = torch.sum(resid ** 2)
        _, grads = voxel_grads_fast(merged, opts, 2.0 * resid, camera_x_offset, image=img)
        for key, p in params.items():
            p.grad = grads[key].reshape(p.shape)
    optimizer.step()
    return loss
