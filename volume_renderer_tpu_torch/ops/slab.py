"""Single-device z-slab sweep for volumes larger than device memory, in plain
PyTorch (port of ``volume_renderer_tpu.ops.slab``).

Two tiers, as in the JAX package:

- ``render_forward_slabbed``: the grids stay on the scene's device; slab s
  (plus ``HALO`` rows each side, clamped into the volume) is a view of them.
- ``render_forward_streamed``: the grids stay in host memory (CPU tensors);
  one slab of each role at a time is copied to the device that marches.

Front-to-back "under" compositing is associative over (premultiplied color,
alpha) segments, so sweeping the slabs in each ray's own order reproduces
the flat march, the opacity-threshold early exit included. Rays whose
direction has dz >= 0 pass the slabs in ascending z order, the others in
descending order: two sweeps with disjoint ray masks share one state. A
march step belongs to slab ``clip(floor(z_norm * B), 0, B - 1)`` at its
position, the owner rule of ``parallel/bricks.py``, so every step runs once.
Positions are taken in closed form, ``pos0 + n * step``, as the JAX package
takes them (ulp-level drift against the accumulated ``pos += step`` of
``ops/forward.py``).

This module is the plain version. On a CUDA card the same sweep runs through
the z-brick kernels' launch forms (K7), one slab at a time
(``ops/cuda_slab.py``): the streamed entry points here go there when the
march runs on a card (``device=None`` means the card), and march in plain
PyTorch on the CPU (``device="cpu"``). ``render_forward_slabbed`` and
``render_fused_slabbed`` are plain PyTorch on whatever device the scene is;
``cuda_slab.render_forward_slabbed_fast`` is their kernel route.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.brick_march import HALO, Slab, brick_samplers
from volume_renderer_tpu_torch.ops.float3 import F3
from volume_renderer_tpu_torch.ops.forward import _init_rays
from volume_renderer_tpu_torch.ops.vjp import GRID_KEYS, StepReplay, merge_scene, split_scene

# slab-carried volume roles, in a fixed order (a subset is active per scene)
_ROLES = ("em", "ab", "re", "gx", "gy", "gz")
_NAME_OF = dict(zip(_ROLES, ("emission", "absorption", "reflection", "gradient_x",
                             "gradient_y", "gradient_z")))


def _check_divisible(scene: Scene, n: int) -> None:
    # only the roles the march samples (e.g. the facade's (1, 1, 1)
    # reflection placeholder is never sampled when lighting is off)
    for role, data in _role_volumes(scene).items():
        d = data.shape[0]
        if d % n != 0:
            raise ValueError(f"{role} depth {d} must be divisible by n_slabs={n} "
                             f"(pad the volume)")
        if d // n + 2 * HALO > d:
            raise ValueError(f"n_slabs={n} too fine for depth {d}: slab+halo would "
                             f"exceed the volume")


def _role_volumes(scene: Scene) -> Dict[str, torch.Tensor]:
    """role -> whole volume tensor, for every role the march samples."""
    out = {"em": scene.emission.data}
    if not scene.absorption_aliased:
        out["ab"] = scene.absorption.data
    if scene.has_lighting:
        if not scene.reflection_aliased:
            out["re"] = scene.reflection.data
        if scene.has_gradient_volumes:
            out["gx"] = scene.gradient_x.data
            out["gy"] = scene.gradient_y.data
            out["gz"] = scene.gradient_z.data
    return out


def _slab_window(d: int, n_slabs: int, s: int) -> Tuple[int, int]:
    """Clamped (start, rows) of slab s's halo-padded window in a depth-d grid."""
    bd = d // n_slabs
    rows = bd + 2 * HALO
    return min(max(s * bd - HALO, 0), d - rows), rows


def slab_of(scene: Scene, s: int, n_slabs: int, windows: Optional[Dict[str, torch.Tensor]] = None
            ) -> Slab:
    """Slab ``s`` of ``n_slabs``: ``scene`` with every sampled role's grid
    replaced by its clamped window, a view of the grid (or, for the roles in
    ``windows``, that tensor of the window's shape), and every grid that the
    march does not sample by a (1, 1, 1) placeholder."""
    windows = windows or {}
    changes = {}
    sampled = _role_volumes(scene)
    for key in GRID_KEYS:  # a grid the march does not sample stays out of the slab
        vol = getattr(scene, key)
        if vol is not None and key not in (_NAME_OF[r] for r in sampled):
            changes[key] = vol.replace(data=vol.data.new_zeros((1, 1, 1)))
    for role, data in sampled.items():
        name = _NAME_OF[role]
        if role in windows:
            win = windows[role]
        else:
            start, rows = _slab_window(data.shape[0], n_slabs, s)
            win = data[start:start + rows]
        changes[name] = getattr(scene, name).replace(data=win)
    return Slab(scene.replace(**changes), s, n_slabs)


def placeholders(scene: Scene, device: torch.device) -> Scene:
    """``scene`` with every tensor but the grids on ``device`` and each grid
    replaced by a (1, 1, 1) placeholder there: the march of a host-resident
    scene, whose slabs take the placeholders' places. ``opts`` must come from
    the real grids."""
    ph = torch.zeros((1, 1, 1), dtype=torch.float32, device=device)
    vols = {k: getattr(scene, k).replace(data=ph)
            for k in GRID_KEYS if getattr(scene, k) is not None}
    s = scene.settings
    settings = dataclasses.replace(
        s, **{f.name: getattr(s, f.name).to(device) for f in dataclasses.fields(s)})
    tensors = {k: None if getattr(scene, k) is None else getattr(scene, k).to(device)
               for k in ("illumination", "light_positions", "light_colors")}
    return scene.replace(camera=scene.camera.to(device), settings=settings, **vols, **tensors)


class _Rays:
    """The per-ray march set-up that every slab shares."""

    def __init__(self, scene: Scene, opts: RenderOptions, camera_x_offset: float,
                 y_offset: int, n_rows: int):
        (self.consts, self.origin, self.pos0, self.step, self.tnear, self.tfar,
         self.hit) = _init_rays(scene, opts, camera_x_offset, y_offset, n_rows)
        self.n_steps = opts.n_steps

    def pos_at(self, n_cur: torch.Tensor) -> F3:
        nf = n_cur.to(torch.float32)
        return self.pos0 + F3(self.step.x * nf, self.step.y * nf, self.step.z * nf)

    def dz(self) -> torch.Tensor:
        return self.step.z / self.consts.tstep

    def marchable(self, n_cur, w, mask, early_exit: bool) -> torch.Tensor:
        """Rays that still have steps to run (in whatever slab)."""
        t = self.tnear + self.consts.tstep * n_cur.to(torch.float32)
        alive = self.hit & mask & (n_cur < self.n_steps) & (t <= self.tfar)
        if early_exit:
            alive = alive & (w <= self.consts.opacity_threshold)
        # the reference's unconditional first step (t == tnear runs even
        # when tnear > tfar after the behind-camera clamp)
        return alive | (self.hit & mask & (n_cur == 0))

    def owner(self, n: int):
        """The slab that owns a step at z position ``pos_z``."""
        zmin, inv_bz = self.consts.boxmin[2], self.consts.boxscale[2]

        def owner_of(pos_z):
            znorm = (pos_z - zmin) * inv_bz
            return torch.clamp(torch.floor(znorm * n).to(torch.int32), 0, n - 1)

        return owner_of

    def sweeps(self):
        """(mask, ascending) of each sweep that owns a ray: dz >= 0 ascending,
        dz < 0 descending."""
        up = self.dz() >= 0
        return [(mask, asc) for mask, asc in ((up, True), (~up, False))
                if bool((self.hit & mask).any())]


def _march_one_slab(scene: Scene, rays: _Rays, samplers, owner_of, s: int, mask, state,
                    early_exit: bool):
    """Runs every masked ray through its steps that slab ``s`` owns."""
    n_cur, rgb, w = state
    while True:
        pos = rays.pos_at(n_cur)
        active = rays.marchable(n_cur, w, mask, early_exit) & (owner_of(pos.z) == s)
        if not bool(active.any()):
            return n_cur, rgb, w
        s_rgb, alpha = core.march_step(scene, rays.consts, pos, rays.origin, samplers)
        new_rgb, new_w = core.composite_under(rgb, w, s_rgb, alpha)
        rgb = F3(*(torch.where(active, a, b) for a, b in zip(new_rgb, rgb)))
        w = torch.where(active, new_w, w)
        n_cur = torch.where(active, n_cur + 1, n_cur)


def _image_of(rgb: F3, n_rows: int, width: int) -> torch.Tensor:
    return torch.stack([c.reshape(n_rows, width) for c in rgb], dim=-1)


def _initial_state(rays: _Rays):
    zeros = torch.zeros_like(rays.tnear)
    return torch.zeros_like(rays.tnear, dtype=torch.int32), F3(zeros, zeros, zeros), zeros


def render_forward_slabbed(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0, *,
                           n_slabs: int, y_offset: int = 0, n_rows: Optional[int] = None,
                           early_exit: bool = True) -> torch.Tensor:
    """Forward render sweeping the scene's grids in ``n_slabs`` z-slabs, in
    plain PyTorch on the scene's device; (n_rows, W, 3).

    Agrees with ``render_forward`` to rounding, the exact per-ray
    opacity-threshold early termination included (``early_exit=True``).
    Each step samples one halo-padded window per role, a view of the grid.
    Raises ``ValueError`` where ``n_slabs`` does not divide a sampled
    volume's depth or a slab and its halo exceed it.
    """
    _check_divisible(scene, n_slabs)
    n_rows = opts.height if n_rows is None else int(n_rows)
    with torch.no_grad():
        rays = _Rays(scene, opts, camera_x_offset, y_offset, n_rows)
        owner_of = rays.owner(n_slabs)
        state = _initial_state(rays)
        for mask, ascending in rays.sweeps():
            order = range(n_slabs) if ascending else range(n_slabs - 1, -1, -1)
            for s in order:
                if not bool(rays.marchable(state[0], state[2], mask, early_exit).any()):
                    break  # every ray of this sweep has finished
                slab = slab_of(scene, s, n_slabs)
                state = _march_one_slab(slab.scene, rays, brick_samplers(slab), owner_of, s,
                                        mask, state, early_exit)
        return _image_of(state[1], n_rows, opts.width)


# ---- host-streamed tier -----------------------------------------------------


def _host_windows(scene: Scene, s: int, n_slabs: int, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """Slab ``s``'s window of every sampled role, copied to ``device``."""
    out = {}
    for role, data in _role_volumes(scene).items():
        start, rows = _slab_window(data.shape[0], n_slabs, s)
        out[role] = data[start:start + rows].to(device, torch.float32)
    return out


def render_forward_streamed(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0,
                            *, n_slabs: int, device: DeviceLike = None) -> torch.Tensor:
    """Forward render with host-resident grids, one slab at a time on
    ``device``; (H, W, 3) there.

    ``scene``'s grids may be CPU tensors of any size: only one halo-padded
    window per role is ever on the device; the per-ray (color, opacity,
    cursor) state stays there between slabs. ``device=None`` is the CUDA
    card, where the sweep runs through the K7 launch forms
    (``ops.cuda_slab.render_forward_streamed_fast``, lit scenes through the
    lit phase 2); ``device="cpu"`` runs it here in plain PyTorch.
    """
    dev = resolve_device(device)
    _check_divisible(scene, n_slabs)
    if dev.type == "cuda":
        from volume_renderer_tpu_torch.ops import cuda_slab

        return cuda_slab.render_forward_streamed_fast(scene, opts, camera_x_offset,
                                                      n_slabs=n_slabs, device=dev)
    slim = placeholders(scene, dev)
    with torch.no_grad():
        rays = _Rays(slim, opts, camera_x_offset, 0, opts.height)
        owner_of = rays.owner(n_slabs)
        state = _initial_state(rays)
        for mask, ascending in rays.sweeps():
            order = range(n_slabs) if ascending else range(n_slabs - 1, -1, -1)
            for s in order:
                slab = slab_of(slim, s, n_slabs, _host_windows(scene, s, n_slabs, dev))
                state = _march_one_slab(slab.scene, rays, brick_samplers(slab), owner_of, s,
                                        mask, state, True)
                if not bool(rays.marchable(state[0], state[2], mask, True).any()):
                    break  # every ray of this sweep finished early
        return _image_of(state[1], opts.height, opts.width)


# ---- the replay over the slabs ------------------------------------------------


def _replay_slabs(scene: Scene, opts: RenderOptions, camera_x_offset: float, n_slabs: int,
                  g: torch.Tensor, image: torch.Tensor, slab_at, add_slab) -> Dict:
    """The slab sweep's replay backward (the prefix-dot replay of
    ``ops/vjp.py``): every slab's steps are replayed from taps fetched in
    that slab (``slab_at(s)`` gives it), and ``add_slab(slab, grads)``
    receives each slab's gradients, its grids shaped like its windows.
    Returns the parameters' gradients summed over the slabs."""
    rays = _Rays(scene, opts, camera_x_offset, 0, opts.height)
    owner_of = rays.owner(n_slabs)
    n_cur, _, w = _initial_state(rays)
    prefix = torch.zeros_like(w)
    params: Dict[str, torch.Tensor] = {}
    for mask, ascending in rays.sweeps():
        order = range(n_slabs) if ascending else range(n_slabs - 1, -1, -1)
        for s in order:
            if not bool(rays.marchable(n_cur, w, mask, True).any()):
                break
            slab = slab_at(s)
            replay = StepReplay(slab.scene, rays.consts, rays.origin, g, image,
                                samplers=brick_samplers(slab), slab_geometry=slab.slab_geometry)
            while True:
                pos = rays.pos_at(n_cur)
                active = rays.marchable(n_cur, w, mask, True) & (owner_of(pos.z) == s)
                if not bool(active.any()):
                    break
                alpha, prefix = replay.step(pos, active, w, prefix)
                w = torch.where(active, w + (1.0 - w) * alpha, w)
                n_cur = torch.where(active, n_cur + 1, n_cur)
            grads = replay.result()
            add_slab(slab, {k: v for k, v in grads.items() if k in GRID_KEYS})
            for key, value in grads.items():
                if key not in GRID_KEYS:
                    params[key] = value if key not in params else params[key] + value
    if not params:  # no ray hit the box
        params = {k: v for k, v in StepReplay(scene, rays.consts, rays.origin, g, image)
                  .result().items() if k not in GRID_KEYS}
    return params


class _RenderFusedSlabbed(torch.autograd.Function):
    """The slab sweep forward, the slab replay backward; saves the image."""

    @staticmethod
    def forward(ctx, template, opts, cam_off, n_slabs, keys, *leaves):
        scene = merge_scene(template, dict(zip(keys, leaves)))
        out = render_forward_slabbed(scene, opts, cam_off, n_slabs=n_slabs)
        ctx.save_for_backward(out, *leaves)
        ctx.static = (template, opts, cam_off, n_slabs, keys)
        return out

    @staticmethod
    def backward(ctx, g):
        template, opts, cam_off, n_slabs, keys = ctx.static
        out, *leaves = ctx.saved_tensors
        scene = merge_scene(template, dict(zip(keys, leaves)))
        with torch.no_grad():
            grads = {key: torch.zeros_like(data) for key, data in
                     ((_NAME_OF[r], v) for r, v in _role_volumes(scene).items())}

            def add_slab(slab, slab_grads):
                for key, value in slab_grads.items():
                    if key in grads:
                        start, _ = slab.slab_geometry(value)
                        grads[key][start:start + value.shape[0]] += value

            grads.update(_replay_slabs(scene, opts, cam_off, n_slabs, g.contiguous(), out,
                                       lambda s: slab_of(scene, s, n_slabs), add_slab))
        # a leaf the march does not sample (an unlit scene's reflection) gets zeros
        return (None,) * 5 + tuple(
            (grads[key] if key in grads else torch.zeros_like(leaf)) if need else None
            for key, leaf, need in zip(keys, leaves, ctx.needs_input_grad[5:]))


def render_fused_slabbed(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0, *,
                         n_slabs: int) -> torch.Tensor:
    """Differentiable z-slab sweep (the drop-in for ``ops.vjp.render_fused``),
    plain PyTorch on the scene's device.

    Forward: ``render_forward_slabbed``. Backward: the same sweep replayed
    with the prefix-dot replay of ``ops/vjp.py``: taps are fetched again
    from each slab's windows, cotangents scatter into full-size gradient
    grids (which training holds anyway). Gradients reach every leaf of
    ``split_scene(scene)`` that requires grad; lit scenes included.
    """
    _check_divisible(scene, n_slabs)
    diff, template = split_scene(scene)
    keys = tuple(diff)
    return _RenderFusedSlabbed.apply(template, opts, float(camera_x_offset), int(n_slabs), keys,
                                     *(diff[k] for k in keys))


# ---- streamed-tier training: host grids, a slab at a time -----------------------


def streamed_grads(scene: Scene, opts: RenderOptions, g: Optional[torch.Tensor], *,
                   n_slabs: int, camera_x_offset: float = 0.0, g_fn=None,
                   device: DeviceLike = None) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Pixel-cotangent backward with host-resident grids.

    ``scene``'s grids may be CPU tensors larger than device memory: one
    halo-padded window per role, and its window-shaped gradient, is on
    ``device`` at a time. Returns ``(grads, image)``: the gradients of the
    sampled grids (keys as in ``ops.vjp.split_scene``: emission, absorption,
    ...) as CPU tensors, the transfer parameters' on ``device``, and the
    streamed forward's image on ``device``.

    Pass ``g_fn`` (image -> cotangent, e.g. the closed-form sum-of-squares
    gradient) instead of ``g`` where the cotangent depends on the forward
    image: the streamed forward runs here anyway.

    ``device=None`` is the CUDA card: the K7 sweep
    (``ops.cuda_slab.streamed_grads_fast``, lit scenes through the lit
    gradient segment, lit lookup scenes through its lookup form). On the CPU
    it is the plain replay; both take every scene.
    """
    dev = resolve_device(device)
    _check_divisible(scene, n_slabs)
    if dev.type == "cuda":
        from volume_renderer_tpu_torch.ops import cuda_slab

        return cuda_slab.streamed_grads_fast(scene, opts, g, n_slabs=n_slabs,
                                             camera_x_offset=camera_x_offset, g_fn=g_fn,
                                             device=dev)
    out = render_forward_streamed(scene, opts, camera_x_offset, n_slabs=n_slabs, device=dev)
    if g is None:
        g = g_fn(out)
    g = torch.as_tensor(g, dtype=torch.float32, device=dev).contiguous()
    host = _role_volumes(scene)
    host_grads = {_NAME_OF[r]: torch.zeros(v.shape, dtype=torch.float32) for r, v in host.items()}
    slim = placeholders(scene, dev)

    def add_slab(slab, slab_grads):
        for key, value in slab_grads.items():
            if key in host_grads:
                start, _ = slab.slab_geometry(value)
                host_grads[key][start:start + value.shape[0]] += value.cpu()

    with torch.no_grad():
        params = _replay_slabs(
            slim, opts, camera_x_offset, n_slabs, g, out,
            lambda s: slab_of(slim, s, n_slabs, _host_windows(scene, s, n_slabs, dev)),
            add_slab)
    host_grads.update(params)
    return host_grads, out
