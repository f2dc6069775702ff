"""Voxel-brick sharding: the volume cut along z across devices (port of
``volume_renderer_tpu.parallel.bricks``).

Brick b of B holds z-rows [b * D / B, (b + 1) * D / B) of every volume plus
a ``HALO``-row copy of its neighbours' edge rows, and marches the part of
every ray that falls inside it. The port is one process that drives every
device: ``mesh`` is a list of B ``torch.device``s (``parallel.mesh.make_mesh``),
brick b lives on ``mesh[b]``, and a device may appear more than once. On
one card all bricks share it; on a host with several cards the same code
spreads them, and every pass launches all bricks before any copy between
devices, so the cards work at the same time.

Exact early termination without a ring
--------------------------------------
The single-device march breaks a ray at the first step whose accumulated
opacity passes the threshold: a dependency from brick to brick. The
transmittance algebra makes it two parallel phases:

1. every brick marches a transmittance-only pass over its own samples,
   ``T_b = prod (1 - alpha)``, which does not depend on what the ray
   carries in. It fetches absorption alone and stops once its own opacity
   passes the threshold (the ray then dies in this brick at the latest);
2. the (B, H, W) transmittances are stacked on ``mesh[0]``; a ``cumprod``
   in ascending and one in descending brick order give every brick the
   product of the bricks in front of it, picked per ray by the sign of its
   direction's z; ``w_in = 1 - that`` goes back to the brick, which marches
   its shaded segment from that entry opacity with the exact per-step
   break. Its contribution is already weighted by the transmittance of
   everything in front, so the image is the plain sum of the contributions.

Phase 1 also leaves every ray's entry record in every brick (the first step
the brick owns, with its t and position; ``brick_march.Entry``), on the
brick's device beside ``w_in``. Phase 2 and the gradient segment resume
from it, so only phase 1 walks a ray from its first step to the brick.

Exactness caveat: phase 1's stop and the skip of rays with
``w_in > threshold`` assume alpha >= 0 (opacity monotone along the ray),
true for any non-negative absorption volume. Negative absorption renders
exactly on the single-device paths only.

``w_in = 1 - prod T`` equals the sequential ``w += (1 - w) * alpha`` only to
rounding, so a ray that stops within an ulp of the threshold may take one
sample more or less than the single-device march. Positions are the
single-device march's own, bit for bit (``ops/brick_march.py``).

The backward replays each brick's own samples (``ops.vjp.StepReplay``), with
a ``cumsum`` relay of the bricks' contribution dots in the same two orders
making the prefix global; it scatters into halo-padded grids, folds the
halo rows back into the bricks that own them (``_return_halo``) and sums
the parameters' gradients over the bricks.

Entry points. ``render_forward_bricked`` and ``render_fused_bricked`` are
plain PyTorch on any devices and take lit scenes. ``render_forward_bricked_fast``,
``voxel_grads_bricked_fast`` and ``train_step_fast_bricked`` run the brick
kernels (``ops/cuda_bricks.py``) on CUDA bricks and the same plain passes on
CPU bricks; they take unlit scenes only and raise ``NotImplementedError``
for a lit one. All take a ``Scene`` (split on every call) or a
``BrickedScene`` (split once, ``split_bricks``), return the image on
``mesh[0]``, and raise ``ValueError`` for a depth that B does not divide or
bricks thinner than 2 rows; depth-1 volumes are copied whole to every brick.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks
from volume_renderer_tpu_torch.ops.brick_march import HALO, Brick, Entry
from volume_renderer_tpu_torch.ops.forward import _init_rays
from volume_renderer_tpu_torch.ops.vjp import GRID_KEYS, merge_scene, split_scene

Mesh = Sequence[torch.device]
PerBrick = List[torch.Tensor]


class BrickedScene(NamedTuple):
    """A scene cut into bricks, brick b on ``mesh[b]``."""

    bricks: Tuple[Brick, ...]

    @property
    def mesh(self) -> List[torch.device]:
        return [brick.device for brick in self.bricks]

    @property
    def n(self) -> int:
        return len(self.bricks)


def _check_divisible(scene: Scene, n: int, skip: Sequence[str] = ()) -> None:
    for name in GRID_KEYS:
        vol = getattr(scene, name)
        # depth-1 volumes (the facade's default reflection) are copied whole
        if vol is None or name in skip or vol.data.shape[0] == 1:
            continue
        depth = vol.data.shape[0]
        if depth % n != 0:
            raise ValueError(f"{name} depth {depth} must be divisible by the brick mesh "
                             f"size {n} (pad the volume)")
        if depth // n < HALO:
            raise ValueError(f"{name} depth {depth} over {n} bricks gives a brick depth "
                             f"below {HALO} rows: use fewer bricks")


def _with_halo(chunks: Sequence[torch.Tensor]) -> PerBrick:
    """Brick b's rows between the last ``HALO`` rows of brick b - 1 and the
    first of brick b + 1, on brick b's device. The two edge bricks get zeros
    for the halo they lack: the fetch clamps z against the whole depth, so
    those rows are never sampled."""
    n = len(chunks)
    out = []
    for b, own in enumerate(chunks):
        zeros = own.new_zeros((HALO,) + tuple(own.shape[1:]))
        lo = chunks[b - 1][-HALO:].to(own.device) if b > 0 else zeros
        hi = chunks[b + 1][:HALO].to(own.device) if b < n - 1 else zeros
        out.append(torch.cat([lo, own, hi], dim=0))
    return out


def _return_halo(padded: Sequence[torch.Tensor]) -> PerBrick:
    """Adjoint of ``_with_halo``: every halo row's gradient is added to the
    row of the neighbour that owns it; the outer halos of the two edge
    bricks, which nothing samples, are dropped."""
    n = len(padded)
    out = []
    for b, grad in enumerate(padded):
        center = grad[HALO:-HALO].clone()
        if b < n - 1:  # the next brick's low halo holds my last rows
            center[-HALO:] += padded[b + 1][:HALO].to(center.device)
        if b > 0:
            center[:HALO] += padded[b - 1][-HALO:].to(center.device)
        out.append(center)
    return out


def _is_whole(data: torch.Tensor) -> bool:
    """A depth-1 volume is not cut: every brick holds all of it."""
    return data.shape[0] == 1


def _brick_grids(data: torch.Tensor, mesh: Mesh) -> PerBrick:
    """The per-brick (unpadded) parts of one grid, on their devices."""
    if _is_whole(data):
        return [data.to(dev) for dev in mesh]
    return [chunk.to(dev) for chunk, dev in zip(data.chunk(len(mesh), dim=0), mesh)]


def _pad(parts: PerBrick) -> PerBrick:
    return list(parts) if _is_whole(parts[0]) else _with_halo(parts)


def _fold(padded: PerBrick) -> PerBrick:
    """Per-brick gradients of the unpadded parts from those of the padded
    grids; a whole volume's gradient is the sum over the bricks, on each."""
    if not _is_whole(padded[0]):
        return _return_halo(padded)
    total = sum(p.to(padded[0].device) for p in padded)
    return [total.to(p.device) for p in padded]


def assemble(parts: PerBrick, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """The whole grid from its per-brick parts, on ``device`` (default: the
    first brick's)."""
    dev = parts[0].device if device is None else torch.device(device)
    if _is_whole(parts[0]):
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts], dim=0)


def _check_mesh(mesh: Mesh) -> List[torch.device]:
    if mesh is None or isinstance(mesh, (str, torch.device)) or len(mesh) < 1:
        raise ValueError("mesh must be a list of devices, one per brick "
                         "(parallel.mesh.make_mesh)")
    return [torch.device(d) for d in mesh]


def split_bricks(scene: Scene, mesh: Mesh, grids: Optional[Dict[str, PerBrick]] = None
                 ) -> BrickedScene:
    """``scene`` cut into ``len(mesh)`` halo-padded bricks on their devices.

    ``grids`` (key -> unpadded per-brick parts) takes the place of the
    scene's own volumes of those keys, which then are not read."""
    mesh = _check_mesh(mesh)
    n = len(mesh)
    grids = dict(grids or {})
    _check_divisible(scene, n, skip=tuple(grids))
    padded = {}
    for key in GRID_KEYS:
        vol = getattr(scene, key)
        if key in grids:
            padded[key] = _pad([part.detach() for part in grids[key]])
        elif vol is not None:
            padded[key] = _pad(_brick_grids(vol.data.detach(), mesh))

    s = scene.settings
    bricks = []
    for b, dev in enumerate(mesh):
        settings = dataclasses.replace(
            s, **{f.name: getattr(s, f.name).to(dev) for f in dataclasses.fields(s)})
        volumes = {key: getattr(scene, key).replace(data=parts[b].contiguous())
                   for key, parts in padded.items()}
        tensors = {key: None if getattr(scene, key) is None else getattr(scene, key).to(dev)
                   for key in ("illumination", "light_positions", "light_colors")}
        bricks.append(Brick(scene.replace(camera=scene.camera.to(dev), settings=settings,
                                          **volumes, **tensors),
                            b, n))
    return BrickedScene(tuple(bricks))


def _as_bricked(scene: Union[Scene, BrickedScene], mesh: Optional[Mesh]) -> BrickedScene:
    if isinstance(scene, BrickedScene):
        if mesh is not None and _check_mesh(mesh) != scene.mesh:
            raise ValueError(f"the scene is split over {scene.mesh}, not over mesh={list(mesh)}")
        return scene
    return split_bricks(scene, mesh)


# ---------------------------------------------------------------------------
# the relay
# ---------------------------------------------------------------------------


def _ascending(bricked: BrickedScene, opts: RenderOptions, camera_x_offset: float
               ) -> torch.Tensor:
    """Per ray (H, W), on ``mesh[0]``: whether it passes the bricks in
    ascending order (the z of its direction is not negative)."""
    step = _init_rays(bricked.bricks[0].scene, opts, camera_x_offset, 0, opts.height)[3]
    return (step.z >= 0).reshape(opts.height, opts.width)


def _upstream(values: PerBrick, ascending: torch.Tensor,
              scan: Callable[..., torch.Tensor], identity: float) -> PerBrick:
    """For every brick the ``scan`` (``cumprod`` or ``cumsum``) of ``values``
    (one (H, W) tensor per brick, on its device) over the bricks in front of
    it, in each ray's own order; ``identity`` where none is in front. The
    scans run on ``ascending``'s device, the results go back."""
    dev0 = ascending.device
    stacked = torch.stack([v.to(dev0) for v in values])  # (B, H, W)
    ident = torch.full_like(stacked[:1], identity)
    up_asc = torch.cat([ident, scan(stacked, dim=0)[:-1]])
    up_desc = torch.cat([scan(stacked.flip(0), dim=0).flip(0)[1:], ident])
    up = torch.where(ascending, up_asc, up_desc)
    return [up[b].to(v.device) for b, v in enumerate(values)]


class _Forward(NamedTuple):
    """What the forward leaves for the backward."""

    image: torch.Tensor   # (H, W, 3) on mesh[0]
    ascending: torch.Tensor
    w_in: PerBrick        # (H, W) each, on the bricks' devices
    own: PerBrick         # (H, W, 3) each: the bricks' contributions
    entry: List[Entry]    # phase 1's entry records, on the bricks' devices


def _forward(bricked: BrickedScene, opts: RenderOptions, camera_x_offset: float,
             fast: bool) -> _Forward:
    transmittance = cuda_bricks.brick_transmittance if fast else brick_march.transmittance_pass
    segment = cuda_bricks.brick_segment if fast else brick_march.shaded_pass
    with torch.no_grad():
        ascending = _ascending(bricked, opts, camera_x_offset)
        # every brick's pass is enqueued before the first copy between devices
        w_local, entry = zip(*(transmittance(brick, opts, camera_x_offset)
                               for brick in bricked.bricks))
        up_t = _upstream([1.0 - w for w in w_local], ascending, torch.cumprod, 1.0)
        w_in = [1.0 - t for t in up_t]
        own = [segment(brick, opts, camera_x_offset, w, entry=e)[0]
               for brick, w, e in zip(bricked.bricks, w_in, entry)]
        image = torch.stack([o.to(ascending.device) for o in own]).sum(dim=0)
    return _Forward(image, ascending, w_in, own, list(entry))


def _backward(bricked: BrickedScene, opts: RenderOptions, camera_x_offset: float,
              g: torch.Tensor, fwd: _Forward, fast: bool) -> Dict:
    """The gradients for the pixel cotangent ``g`` (H, W, 3): grid keys as
    per-brick tensors shaped like the bricks' unpadded parts, on their
    devices; parameter keys summed over the bricks, on ``mesh[0]``."""
    dev0 = fwd.image.device
    with torch.no_grad():
        g = g.to(dev0, torch.float32).contiguous()
        g_on = [g.to(brick.device) for brick in bricked.bricks]
        image_on = [fwd.image.to(brick.device) for brick in bricked.bricks]
        dots = [brick_march.own_dot(gb, own) for gb, own in zip(g_on, fwd.own)]
        up_dot = _upstream(dots, fwd.ascending, torch.cumsum, 0.0)
        segment_grads = cuda_bricks.brick_gradients if fast else brick_march.replay_pass
        per_brick = [segment_grads(brick, opts, camera_x_offset, gb, image, w, up, entry=e)
                     for brick, gb, image, w, up, e in zip(bricked.bricks, g_on, image_on,
                                                           fwd.w_in, up_dot, fwd.entry)]
        grads: Dict = {}
        for key in per_brick[0]:
            parts = [p[key] for p in per_brick]
            if key in GRID_KEYS:
                grads[key] = _fold(parts)
            else:
                grads[key] = torch.stack([p.to(dev0) for p in parts]).sum(dim=0)
        return grads


# ---------------------------------------------------------------------------
# plain entry points
# ---------------------------------------------------------------------------


def render_forward_bricked(scene: Union[Scene, BrickedScene], opts: RenderOptions,
                           camera_x_offset: float = 0.0, *, mesh: Optional[Mesh] = None
                           ) -> torch.Tensor:
    """Forward render with the volume cut along z over ``mesh``, in plain
    PyTorch on whatever devices the mesh names; (H, W, 3) on ``mesh[0]``.

    Agrees with the single-device render including the exact
    opacity-threshold early termination (the two-phase relay of the module
    docstring). Takes unlit and lit scenes (on-the-fly and lookup
    gradients). ``opts`` are the whole scene's.
    """
    return _forward(_as_bricked(scene, mesh), opts, float(camera_x_offset), fast=False).image


class _RenderFusedBricked(torch.autograd.Function):
    """The bricked march forward, the per-brick replay backward."""

    @staticmethod
    def forward(ctx, template, opts, cam_off, mesh, keys, *leaves):
        scene = merge_scene(template, dict(zip(keys, leaves)))
        fwd = _forward(split_bricks(scene, mesh), opts, cam_off, fast=False)
        ctx.save_for_backward(*leaves)
        ctx.static = (template, opts, cam_off, mesh, keys, fwd)
        return fwd.image

    @staticmethod
    def backward(ctx, g):
        template, opts, cam_off, mesh, keys, fwd = ctx.static
        leaves = ctx.saved_tensors
        scene = merge_scene(template, dict(zip(keys, leaves)))
        grads = _backward(split_bricks(scene, mesh), opts, cam_off, g, fwd, fast=False)
        out = []
        for key, leaf, need in zip(keys, leaves, ctx.needs_input_grad[5:]):
            if not need:
                out.append(None)
            elif key in GRID_KEYS:
                out.append(assemble(grads[key], leaf.device))
            else:
                out.append(grads[key].to(leaf.device))
        return (None,) * 5 + tuple(out)


def render_fused_bricked(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0, *,
                         mesh: Mesh) -> torch.Tensor:
    """Differentiable bricked render (the drop-in for ``ops.vjp.render_fused``),
    (H, W, 3) on ``mesh[0]``, in plain PyTorch.

    Forward: the two-phase bricked march. Backward: every brick replays its
    own samples with cotangents that see the whole ray, scatters into its
    halo-padded grids, the halo rows return to their owners and the
    parameters' gradients are summed over the bricks. Gradients reach every
    leaf of ``split_scene(scene)`` that requires grad, whole, on the leaf's
    device. Takes unlit and lit scenes.
    """
    diff, template = split_scene(scene)
    keys = tuple(diff)
    return _RenderFusedBricked.apply(template, opts, float(camera_x_offset),
                                     tuple(_check_mesh(mesh)), keys, *(diff[k] for k in keys))


# ---------------------------------------------------------------------------
# entry points at kernel speed
# ---------------------------------------------------------------------------


def render_forward_bricked_fast(scene: Union[Scene, BrickedScene], opts: RenderOptions,
                                camera_x_offset: float = 0.0, *, mesh: Optional[Mesh] = None
                                ) -> torch.Tensor:
    """Bricked forward render with the brick kernel per brick: 2 launches a
    brick (phase 1, phase 2) on CUDA bricks, the plain passes on CPU bricks;
    (H, W, 3) on ``mesh[0]``. Any camera; unlit scenes only (a lit one
    raises ``NotImplementedError``: ``render_forward_bricked`` renders it).
    """
    return _forward(_as_bricked(scene, mesh), opts, float(camera_x_offset), fast=True).image


def _voxel_grads(bricked: BrickedScene, opts: RenderOptions, g, camera_x_offset: float,
                 fwd: _Forward) -> Dict:
    g = torch.as_tensor(g, dtype=torch.float32, device=fwd.image.device)
    if tuple(g.shape) != tuple(fwd.image.shape):
        raise ValueError(f"g must be {tuple(fwd.image.shape)}, got {tuple(g.shape)}")
    return _backward(bricked, opts, camera_x_offset, g, fwd, fast=True)


def voxel_grads_bricked_fast(scene: Union[Scene, BrickedScene], opts: RenderOptions, g,
                             camera_x_offset: float = 0.0, *, mesh: Optional[Mesh] = None
                             ) -> Tuple[torch.Tensor, Dict]:
    """Bricked backward at kernel speed: ``(image, grads)`` like
    ``ops.cuda_grads.voxel_grads_fast``, 3 launches a brick (phase 1,
    phase 2, gradient segment) on CUDA bricks.

    The grids stay cut: ``emission``, ``absorption`` (if not aliased) and
    ``reflection`` (if not aliased; zeros) are lists of per-brick tensors
    (D / B, H, W) on the bricks' devices (``assemble`` joins them); the
    parameters' gradients are summed over the bricks, on ``mesh[0]``.
    Unlit scenes only: a lit one raises ``NotImplementedError``, and
    ``render_fused_bricked`` differentiates it.
    """
    bricked = _as_bricked(scene, mesh)
    cam = float(camera_x_offset)
    fwd = _forward(bricked, opts, cam, fast=True)
    return fwd.image, _voxel_grads(bricked, opts, g, cam, fwd)


Params = Dict[str, Union[torch.Tensor, PerBrick]]


def split_params_bricked(scene: Scene, mesh: Mesh) -> Tuple[Params, BrickedScene]:
    """``scene`` as (trainable parameters, the bricked scene they go back
    into), the counterpart of ``train.split_params`` for a cut volume.

    ``emission`` and, unless aliased, ``absorption`` are lists of per-brick
    leaf tensors (D / B, H, W) on the bricks' devices; the three factors and
    the color are leaves on ``mesh[0]``. ``param_leaves`` lists them all for
    an optimizer."""
    mesh = _check_mesh(mesh)
    _check_divisible(scene, len(mesh))
    if _is_whole(scene.emission.data) or (
            not scene.absorption_aliased and _is_whole(scene.absorption.data)):
        raise ValueError("a depth-1 volume is copied to every brick and cannot be trained cut")

    def leaf(t, dev):
        return t.detach().to(dev, copy=True).requires_grad_(True)

    def leaves(data):
        return [leaf(part, dev) for part, dev in zip(data.chunk(len(mesh), dim=0), mesh)]

    s = scene.settings
    params: Params = {"emission": leaves(scene.emission.data)}
    if not scene.absorption_aliased:
        params["absorption"] = leaves(scene.absorption.data)
    for key in ("factor_emission", "factor_absorption", "factor_reflection", "color"):
        params[key] = leaf(getattr(s, key), mesh[0])
    static = split_bricks(scene, mesh, grids={k: v for k, v in params.items()
                                              if k in GRID_KEYS})
    return params, static


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every leaf tensor of ``params``, for ``torch.optim``."""
    leaves: List[torch.Tensor] = []
    for value in params.values():
        leaves.extend(value if isinstance(value, (list, tuple)) else [value])
    return leaves


def merge_params_bricked(params: Params, bricked: BrickedScene) -> BrickedScene:
    """``bricked`` with ``params`` in place of its own leaves: the grids'
    halos are exchanged anew, the factors and the color go to every brick."""
    padded = {key: _pad([part.detach() for part in params[key]])
              for key in ("emission", "absorption") if key in params}
    bricks = []
    for b, brick in enumerate(bricked.bricks):
        scene = brick.scene
        settings = dataclasses.replace(
            scene.settings,
            **{key: params[key].detach().to(brick.device)
               for key in ("factor_emission", "factor_absorption", "factor_reflection", "color")})
        volumes = {key: getattr(scene, key).replace(data=parts[b].detach().contiguous())
                   for key, parts in padded.items()}
        bricks.append(brick._replace(scene=scene.replace(settings=settings, **volumes)))
    return BrickedScene(tuple(bricks))


def train_step_fast_bricked(params: Params, optimizer: torch.optim.Optimizer,
                            scene: BrickedScene, opts: RenderOptions, target: torch.Tensor, *,
                            mesh: Optional[Mesh] = None, camera_x_offset: float = 0.0
                            ) -> torch.Tensor:
    """One training step at kernel speed with the grids cut across the mesh
    from end to end (sum-of-squares loss): halo exchange, bricked forward,
    closed-form pixel cotangent, gradient segments with the halo rows folded
    back, optimizer. 3 launches a brick. Updates ``params`` (those of
    ``split_params_bricked``: per-brick leaves, each on its device) in place
    and returns the loss before the update, on ``mesh[0]``."""
    if not isinstance(scene, BrickedScene):
        raise TypeError("scene must be the BrickedScene of split_params_bricked")
    if mesh is not None:
        _as_bricked(scene, mesh)
    cam = float(camera_x_offset)
    with torch.no_grad():
        merged = merge_params_bricked(params, scene)
        fwd = _forward(merged, opts, cam, fast=True)
        resid = fwd.image - target.to(fwd.image.device, torch.float32)
        loss = torch.sum(resid ** 2)
        grads = _voxel_grads(merged, opts, 2.0 * resid, cam, fwd)
        for key, value in params.items():
            if isinstance(value, (list, tuple)):
                for p, grad in zip(value, grads[key]):
                    p.grad = grad.reshape(p.shape)
            else:
                value.grad = grads[key].reshape(value.shape).to(value.device)
    optimizer.step()
    return loss
