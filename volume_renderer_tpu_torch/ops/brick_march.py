"""The march of one z-brick in plain PyTorch (port of the per-device passes
of ``volume_renderer_tpu.parallel.bricks``: ``_BrickRays``,
``_brick_samplers``, ``_transmittance_pass``, ``_shaded_pass`` and the loop
of ``_bricked_fused_bwd``).

A brick holds rows [b * bd, (b + 1) * bd) of every volume plus ``HALO``
rows on each side, and marches the part of every ray that it owns. The
three passes here are the plain versions of the brick kernels
(``csrc/brick_fwd.cu``, ``csrc/brick_bwd.cu`` behind ``ops/cuda_bricks.py``,
lit scenes included: the lit forms of phase 2 and of the gradient segment)
and the CPU path of their wrappers.

What every pass shares, and the kernels repeat:

- the ray is that of the whole box, and its positions advance by
  accumulation from step 0 (``pos += step``, ``t += tstep``) exactly as
  ``ops/forward.py`` advances them, without fetching until the brick is
  reached: every sample has the same position in every brick and in the
  single-device march;
- sample n belongs to the brick ``clamp(floor(z_norm * B), 0, B - 1)``, one
  expression that does not know the brick it is evaluated in, so every
  sample has exactly one owner;
- fetches clamp z against the full depth, then shift into the brick
  (``sample_trilinear_zslab``);
- the first sample of a ray composites unconditionally; every later one only
  while the opacity carried into it is at most the threshold and
  ``t <= tfar``, as in the single-device march. The opacity starts at the
  brick's entry opacity ``w_in``;
- phase 1 (``transmittance_pass``) also returns each ray's ``Entry``: the
  first step the brick owns, with ``t`` and the accumulated position there.
  The walk before that step does not depend on the opacity, so the other
  two passes resume from the record (``entry=``) instead of walking from
  step 0, and take the same samples at the same positions, bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.float3 import F3, dot
from volume_renderer_tpu_torch.ops.forward import _init_rays
from volume_renderer_tpu_torch.ops.sampling import sample_trilinear, sample_trilinear_zslab
from volume_renderer_tpu_torch.ops.vjp import Diff, StepReplay

HALO = 2  # rows each side: a trilinear fetch needs +-1, the on-the-fly gradient taps +-2


class RecordKey(NamedTuple):
    """What an entry record depends on: the march that made it."""

    brick: int
    bricks: int
    options: RenderOptions
    camera: Tuple[float, ...]  # Camera.key(): rotation row-major, focal length, distance
    camera_x_offset: float
    first_row: int
    rows: int


class Entry(NamedTuple):
    """Where each ray enters a brick: its first step that the brick owns.
    ``step`` and ``state`` are the kernels' record (``csrc/brick_common.cuh``),
    field for field; ``made_for`` is ``Entry.key`` of the march that found
    it, and a pass that resumes from the record refuses it for another."""

    step: torch.Tensor   # (H, W) int32; -1 where the ray misses the box or never reaches the brick
    state: torch.Tensor  # (H, W, 4) float32: t and the position x, y, z at that step
    made_for: RecordKey

    @staticmethod
    def key(brick: "Brick", opts: RenderOptions, camera_x_offset: float, y_offset: int = 0,
            n_rows: Optional[int] = None) -> RecordKey:
        """What a record depends on: the brick and the number of bricks,
        the options, the camera and its offset, and the band of image rows."""
        rows = opts.height if n_rows is None else int(n_rows)
        return RecordKey(brick.index, brick.n, opts, brick.scene.camera.key(),
                         float(camera_x_offset), int(y_offset), rows)

    def check(self, want: RecordKey) -> None:
        """Raises ``ValueError`` unless the record was made for ``want``, an
        ``Entry.key``."""
        if self.made_for != want:
            differ = ", ".join(f"{name} {got} (not {wanted})" for name, got, wanted
                               in zip(RecordKey._fields, self.made_for, want) if got != wanted)
            raise ValueError(f"the entry record was made for another march: {differ}")

    def rows(self, y_offset: int, n_rows: int) -> "Entry":
        """The record of a band of image rows."""
        cut = slice(y_offset, y_offset + n_rows)
        return Entry(self.step[cut].contiguous(), self.state[cut].contiguous(),
                     self.made_for._replace(first_row=self.made_for.first_row + y_offset,
                                            rows=n_rows))


class Brick(NamedTuple):
    """Brick ``index`` of ``n``: a scene whose volumes are halo-padded
    z-bricks (bd + 2 HALO, H, W) on one device, depth-1 volumes whole, with
    the camera, the settings and the lights on that device too."""

    scene: Scene
    index: int
    n: int

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def slab_geometry(self, data: torch.Tensor) -> Tuple[int, int]:
        """(z_offset, full depth) of one of the brick's grids: the global row
        of its first padded row, and the depth of the volume it is cut from."""
        if data.shape[0] == 1:  # replicated whole
            return 0, 1
        bd = data.shape[0] - 2 * HALO
        return self.index * bd - HALO, bd * self.n


class Slab(Brick):
    """Slab ``index`` of ``n`` of a z-slab sweep (``ops/slab.py``): a brick
    whose grids are clamped windows of the whole volumes, bd + 2 HALO rows
    from ``clip(index * bd - HALO, 0, D - rows)`` (the JAX package's
    ``_slab_window``), so that the windows are views of the grids and no
    halo row lies outside the volume. Every pass of this module and every
    brick kernel takes a slab as it takes a brick: the owner rule and the
    entry record are the same, only the rows of the grids differ."""

    __slots__ = ()

    def slab_geometry(self, data: torch.Tensor) -> Tuple[int, int]:
        if data.shape[0] == 1:  # a placeholder, never sampled
            return 0, 1
        rows = data.shape[0]
        bd = rows - 2 * HALO
        full_d = bd * self.n
        return min(max(self.index * bd - HALO, 0), full_d - rows), full_d


def brick_samplers(brick: Brick) -> core.Samplers:
    """Samplers over the brick's padded grids, at global coords."""
    scene = brick.scene

    def sampler(volume):
        z_offset, full_d = brick.slab_geometry(volume)
        return lambda p: sample_trilinear_zslab(volume, p, z_offset, full_d)

    em = sampler(scene.emission.data)
    ab = em if scene.absorption_aliased else sampler(scene.absorption.data)
    re = gx = gy = gz = lut = None
    if scene.has_lighting:
        re = em if scene.reflection_aliased else sampler(scene.reflection.data)
        lut = lambda p: sample_trilinear(scene.illumination, p)  # noqa: E731
        if scene.has_gradient_volumes:
            gx = sampler(scene.gradient_x.data)
            gy = sampler(scene.gradient_y.data)
            gz = sampler(scene.gradient_z.data)
    return core.Samplers(em=em, ab=ab, re=re, gx=gx, gy=gy, gz=gz, lut=lut)


class BrickRays:
    """The rays of the whole image as one brick sees them."""

    def __init__(self, brick: Brick, opts: RenderOptions, camera_x_offset: float,
                 y_offset: int = 0, n_rows: Optional[int] = None):
        self.brick, self.opts = brick, opts
        self.n_rows = opts.height if n_rows is None else int(n_rows)
        self.key = Entry.key(brick, opts, camera_x_offset, y_offset, self.n_rows)
        (self.consts, self.origin, self.pos0, self.step, self.tnear, self.tfar,
         self.hit) = _init_rays(brick.scene, opts, camera_x_offset, int(y_offset), self.n_rows)

    def walk(self, w_in: Optional[torch.Tensor],
             composite: Callable[[F3, torch.Tensor, torch.Tensor], torch.Tensor],
             steps: Optional[torch.Tensor] = None, entry: Optional[Entry] = None
             ) -> Tuple[torch.Tensor, Entry]:
        """Walks every ray through the brick. ``composite(pos, act, sw)`` is
        called at each step where some ray composites a sample (``act``) with
        the opacity ``sw`` carried into it, and returns the samples' alpha.
        With ``entry`` (the record of this brick and these rows) each ray
        starts at its record instead of at step 0, and a ray without one
        takes no sample. Returns the exit opacity (R,) and the entry record:
        the one the walk found, or ``entry``; ``steps`` (int32,
        (n_rows, W)) receives each ray's number of composited samples."""
        consts, opts, step = self.consts, self.opts, self.step
        thr = consts.opacity_threshold
        nb, bf = float(self.brick.n), float(self.brick.index)
        shape = (self.n_rows, opts.width)
        sw = (torch.zeros_like(self.tnear) if w_in is None
              else w_in.reshape(-1).to(torch.float32).clone())
        count = torch.zeros_like(self.tnear, dtype=torch.int32)
        rising, falling = step.z > 0, step.z < 0
        if entry is None:  # every ray that hits the box starts at step 0
            start = torch.where(self.hit, 0, -1).to(torch.int32)
            pos, t = self.pos0, self.tnear
            found = torch.full_like(count, -1)
            found_state = torch.zeros(count.shape + (4,), dtype=torch.float32, device=sw.device)
        else:
            entry.check(self.key)
            start = entry.step.reshape(-1)
            state = entry.state.reshape(-1, 4)
            t, pos = state[:, 0], F3(state[:, 1], state[:, 2], state[:, 3])
        alive = start >= 0

        # a ray holds its starting position and t until its starting step
        i = int(start[alive].min()) if bool(alive.any()) else opts.n_steps
        while i < opts.n_steps:
            started = start <= i
            z_norm = (pos.z - consts.boxmin[2]) * consts.boxscale[2]
            owner = torch.clamp(torch.floor(z_norm * nb), 0.0, nb - 1.0)
            own = owner == bf
            # a ray goes on while it is in the brick or still moving towards it
            going = alive & (own | (rising & (owner < bf)) | (falling & (owner > bf)))
            if entry is None:
                first = going & own & (found < 0)
                found = torch.where(first, torch.full_like(found, i), found)
                found_state = torch.where(first[:, None],
                                          torch.stack([t, pos.x, pos.y, pos.z], dim=-1),
                                          found_state)
            if i > 0:
                going = going & ~(own & ~(sw <= thr))
            alive = torch.where(started, going, alive)
            act = alive & own & started
            # one wait for the device a step: whether any ray goes on or composites
            any_alive, any_act = torch.stack([alive.any(), act.any()]).tolist()
            if not any_alive:
                break
            if any_act:
                alpha = composite(pos, act, sw)
                sw = torch.where(act, (1.0 - sw) * alpha + sw, sw)
                count += act.to(torch.int32)
            t_next = t + consts.tstep
            alive = alive & (~started | (t_next <= self.tfar))
            t = torch.where(started, t_next, t)
            pos = F3(*(torch.where(started, n, o) for n, o in zip(pos + step, pos)))
            i += 1
        if steps is not None:
            steps.copy_(count.reshape(shape))
        if entry is None:
            entry = Entry(found.reshape(shape), found_state.reshape(shape + (4,)), self.key)
        return sw, entry


def transmittance_pass(brick: Brick, opts: RenderOptions, camera_x_offset: float = 0.0,
                       steps: Optional[torch.Tensor] = None, y_offset: int = 0,
                       n_rows: Optional[int] = None) -> Tuple[torch.Tensor, Entry]:
    """Phase 1: the opacity (H, W) that the brick's own samples build up from
    zero, ``1 - prod (1 - alpha)``, and the rays' entry record, which the
    other two passes resume from. Fetches absorption alone. It stops
    where the opacity passes the threshold: with alpha >= 0 the ray then
    dies inside this brick whatever it carried in, and no brick behind it
    uses the value.

    Like the other two passes it can march a band of ``n_rows`` image rows
    from ``y_offset`` alone; every (H, W) above is then (n_rows, W)."""
    rays = BrickRays(brick, opts, camera_x_offset, y_offset, n_rows)
    consts = rays.consts
    sample_ab = brick_samplers(brick).ab

    def composite(pos, act, sw):
        ab = sample_ab(core.to_sample_coords(pos, consts))
        return 1.0 - torch.exp(-(consts.factor_absorption * ab) * consts.tstep)

    w, entry = rays.walk(None, composite, steps)
    return w.reshape(rays.n_rows, opts.width), entry


def shaded_pass(brick: Brick, opts: RenderOptions, camera_x_offset: float,
                w_in: torch.Tensor, steps: Optional[torch.Tensor] = None, y_offset: int = 0,
                n_rows: Optional[int] = None, entry: Optional[Entry] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: the brick's shaded segment from its entry opacity ``w_in``
    (H, W), resumed from phase 1's ``entry`` record if given (else walked
    from step 0). Returns its contribution to the image (H, W, 3), already
    weighted by the transmittance of everything in front of it, and the
    opacity (H, W) the rays leave with."""
    rays = BrickRays(brick, opts, camera_x_offset, y_offset, n_rows)
    samplers = brick_samplers(brick)
    zeros = torch.zeros_like(rays.tnear)
    rgb = [F3(zeros, zeros, zeros)]

    def composite(pos, act, sw):
        shaded, alpha = core.march_step(brick.scene, rays.consts, pos, rays.origin, samplers)
        new_rgb, _ = core.composite_under(rgb[0], sw, shaded, alpha)
        rgb[0] = F3(*(torch.where(act, n, o) for n, o in zip(new_rgb, rgb[0])))
        return alpha

    w_out, _ = rays.walk(w_in, composite, steps, entry)
    shape = (rays.n_rows, opts.width)
    return torch.stack([c.reshape(shape) for c in rgb[0]], dim=-1), w_out.reshape(shape)


def replay_pass(brick: Brick, opts: RenderOptions, camera_x_offset: float, g: torch.Tensor,
                image: torch.Tensor, w_in: torch.Tensor, up_dot: torch.Tensor,
                angle_floor: bool = False, accum_dtype: torch.dtype = torch.float32,
                y_offset: int = 0, n_rows: Optional[int] = None,
                entry: Optional[Entry] = None) -> Diff:
    """The gradient segment: replays the brick's own samples for the pixel
    cotangent ``g`` (H, W, 3), with the adjoint of ``ops.vjp.StepReplay``,
    resumed from phase 1's ``entry`` record if given (else walked from step 0).

    ``image`` is the GLOBAL image, ``w_in`` the entry opacity and ``up_dot``
    (H, W) the sum of ``g . contribution`` over the bricks in front, which
    seeds the prefix so that ``d alpha = -(g . image - prefix) / (1 - alpha)``
    sees the whole ray. Returns the gradients of every leaf of
    ``split_scene(brick.scene)``: the grids halo-padded like the brick's own,
    the parameters as this brick's share of the sum."""
    with torch.no_grad():
        rays = BrickRays(brick, opts, camera_x_offset, y_offset, n_rows)
        replay = StepReplay(brick.scene, rays.consts, rays.origin, g, image,
                            samplers=brick_samplers(brick), slab_geometry=brick.slab_geometry,
                            angle_floor=angle_floor, accum_dtype=accum_dtype)
        prefix = [up_dot.reshape(-1).to(torch.float32)]

        def composite(pos, act, sw):
            alpha, prefix[0] = replay.step(pos, act, sw, prefix[0])
            return alpha

        rays.walk(w_in, composite, entry=entry)
        return replay.result()


def own_dot(g: torch.Tensor, contribution: torch.Tensor) -> torch.Tensor:
    """``g . contribution`` per ray, (H, W): what a brick adds to the prefix
    of the bricks behind it."""
    return dot(F3(*g.unbind(-1)), F3(*contribution.unbind(-1)))
