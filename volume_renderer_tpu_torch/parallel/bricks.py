"""Voxel-brick sharding: the volume cut along z across devices (port of
``volume_renderer_tpu.parallel.bricks``).

Brick b of B holds z-rows [b * D / B, (b + 1) * D / B) of every volume plus
a ``HALO``-row copy of its neighbours' edge rows, and marches the part of
every ray that falls inside it. Here one process drives every device:
``mesh`` is a list of B ``torch.device``s (``parallel.mesh.make_mesh``),
brick b lives on ``mesh[b]``, and a device may appear more than once. On
one card all bricks share it; on a host with several cards the same code
spreads them, and every pass launches all bricks before any copy between
devices, so the cards work at the same time. Where the bricks meet (the
halo rows in and back, the relay of opacities and dots, the image, the
parameters' sums) goes through a ``Relay``; ``parallel.multihost`` runs the
same passes a brick a rank over ``torch.distributed`` with its
``GroupRelay``.

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
plain PyTorch on any devices and take lit scenes. They also take a rows x
bricks mesh (``parallel.mesh.make_mesh_2d``, the JAX package's ``ray_axis``):
band r of the image rows is marched by the bricks of ``mesh[r]`` (the plain
passes take a band), the bands are joined and the gradients summed over
them; the image height must be divisible by the number of bands. The brick
kernels take a band too (``_forward`` with ``n_rows``), which the rows x
bricks ranks of ``parallel.multihost`` march; the one-process fast entry
points take a list of devices alone. ``render_forward_bricked_fast``,
``voxel_grads_bricked_fast`` and ``train_step_fast_bricked`` run the brick
kernels (``ops/cuda_bricks.py``) on CUDA bricks and the same plain passes on
CPU bricks, lit scenes through the lit forms of phase 2 and of the gradient
segment (its lookup form for lookup gradient volumes, whose three grids get
the halo return emission gets). All take a ``Scene`` (split on
every call) or a ``BrickedScene`` (split once, ``split_bricks``;
``train_step_fast_bricked``
also a ``Scene`` with whole params, cut for each step), return the image on
``mesh[0]``, and raise ``ValueError`` for a depth that B does not divide or
bricks thinner than 2 rows; depth-1 volumes are copied whole to every brick.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks
from volume_renderer_tpu_torch.ops.brick_march import HALO, Brick, Entry
from volume_renderer_tpu_torch.ops.forward import _init_rays
from volume_renderer_tpu_torch.ops.vjp import GRID_KEYS, merge_scene, split_scene
from volume_renderer_tpu_torch.parallel.mesh import check_mesh

Mesh = Sequence[torch.device]
PerBrick = List[torch.Tensor]


class Relay:
    """Where the bricks meet: the halo rows in and back, phase 1's opacities
    and the backward's contribution dots to every brick, the image, and the
    sums of the gradients of what every brick holds whole (the JAX
    package's ``ppermute``, ``all_gather`` and ``psum``).

    Every method takes and returns the per-brick lists of the bricks that
    this process holds. This class is one process that holds every brick
    and moves tensors between their devices; ``multihost.GroupRelay`` runs
    the same steps as collectives over a process group, a brick a rank."""

    def with_halo(self, parts: PerBrick) -> PerBrick:
        return _with_halo(parts)

    def return_halo(self, padded: PerBrick) -> PerBrick:
        return _return_halo(padded)

    def whole_sum(self, grads: PerBrick) -> PerBrick:
        """The gradient of a volume every brick holds whole, on each brick."""
        total = sum(p.to(grads[0].device) for p in grads)
        return [total.to(p.device) for p in grads]

    def upstream(self, values: PerBrick, ascending: torch.Tensor,
                 scan: Callable[..., torch.Tensor], identity: float) -> PerBrick:
        return _upstream(values, ascending, scan, identity)

    def image(self, own: PerBrick, device: torch.device) -> torch.Tensor:
        """The bricks' contributions summed, on ``device``."""
        return torch.stack([o.to(device) for o in own]).sum(dim=0)

    def param_sums(self, parts: Dict[str, PerBrick], device: torch.device
                   ) -> Dict[str, torch.Tensor]:
        """Each key's per-brick terms summed over the bricks, on ``device``."""
        return {key: torch.stack([p.to(device) for p in terms]).sum(dim=0)
                for key, terms in parts.items()}

    def band(self, opts: RenderOptions) -> Tuple[int, Optional[int]]:
        """(first row, rows) of the image rows that these bricks march; one
        process marches the whole image (rows None)."""
        return 0, None

    def band_sum(self, tensors: List[torch.Tensor]) -> None:
        """Sums each tensor over the bands of image rows, in place; one
        process marches every row, so there is nothing to add."""


ONE_PROCESS = Relay()


class BrickedScene(NamedTuple):
    """A scene cut into bricks, brick b on ``mesh[b]``; ``relay`` joins them."""

    bricks: Tuple[Brick, ...]
    relay: Relay = ONE_PROCESS

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


def _pad(parts: PerBrick, relay: Relay) -> PerBrick:
    return list(parts) if _is_whole(parts[0]) else relay.with_halo(parts)


def _fold(padded: PerBrick, relay: Relay) -> PerBrick:
    """Per-brick gradients of the unpadded parts from those of the padded
    grids; a whole volume's gradient is the sum over the bricks, on each."""
    if not _is_whole(padded[0]):
        return relay.return_halo(padded)
    return relay.whole_sum(padded)


def assemble(parts: PerBrick, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """The whole grid from its per-brick parts, on ``device`` (default: the
    first brick's)."""
    dev = parts[0].device if device is None else torch.device(device)
    if _is_whole(parts[0]):
        return parts[0].to(dev)
    return torch.cat([p.to(dev) for p in parts], dim=0)


def _is_2d(mesh) -> bool:
    return (isinstance(mesh, (list, tuple)) and len(mesh) > 0
            and all(isinstance(row, (list, tuple)) for row in mesh))


def _check_mesh(mesh: Mesh) -> List[torch.device]:
    if _is_2d(mesh):
        raise ValueError("a rows x bricks mesh (make_mesh_2d) is taken by render_forward_bricked "
                         "and render_fused_bricked alone: the fast bricked path has no ray "
                         "axis, as in the JAX package")
    return check_mesh(mesh, "brick")


def _band_meshes(mesh, opts: RenderOptions) -> List[Tuple[List[torch.device], int, int]]:
    """(the bricks' devices, first row, rows) of every band of image rows:
    one band of the whole image for a list of devices; for a rows x bricks
    mesh, band r is rows [r * H / R, (r + 1) * H / R) on ``mesh[r]``."""
    if not _is_2d(mesh):
        return [(_check_mesh(mesh), 0, opts.height)]
    n = len(mesh)
    if len({len(row) for row in mesh}) != 1:
        raise ValueError("every band of a rows x bricks mesh needs the same number of bricks")
    if opts.height % n != 0:
        raise ValueError(f"image height {opts.height} must be divisible by the ray axis "
                         f"size {n}")
    rows = opts.height // n
    return [(check_mesh(row, "brick"), r * rows, rows) for r, row in enumerate(mesh)]


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
            padded[key] = _pad([part.detach() for part in grids[key]], ONE_PROCESS)
        elif vol is not None:
            padded[key] = _pad(_brick_grids(vol.data.detach(), mesh), ONE_PROCESS)

    return BrickedScene(tuple(brick_of(scene, {key: parts[b] for key, parts in padded.items()},
                                       b, n, dev)
                              for b, dev in enumerate(mesh)))


def brick_of(scene: Scene, padded: Dict[str, torch.Tensor], index: int, n: int,
             device: torch.device) -> Brick:
    """Brick ``index`` of ``n``: ``scene`` with the halo-padded grids of
    ``padded`` (key -> grid, on ``device``) and its camera, settings and
    lights on ``device``."""
    s = scene.settings
    settings = dataclasses.replace(
        s, **{f.name: getattr(s, f.name).to(device) for f in dataclasses.fields(s)})
    volumes = {key: getattr(scene, key).replace(data=grid.contiguous())
               for key, grid in padded.items()}
    tensors = {key: None if getattr(scene, key) is None else getattr(scene, key).to(device)
               for key in ("illumination", "light_positions", "light_colors")}
    return Brick(scene.replace(camera=scene.camera.to(device), settings=settings,
                               **volumes, **tensors),
                 index, n)


def _as_bricked(scene: Union[Scene, BrickedScene], mesh: Optional[Mesh]) -> BrickedScene:
    if isinstance(scene, BrickedScene):
        if mesh is not None and _check_mesh(mesh) != scene.mesh:
            raise ValueError(f"the scene is split over {scene.mesh}, not over mesh={list(mesh)}")
        return scene
    return split_bricks(scene, mesh)


# ---------------------------------------------------------------------------
# the relay
# ---------------------------------------------------------------------------


def _ascending(bricked: BrickedScene, opts: RenderOptions, camera_x_offset: float,
               y_offset: int = 0, n_rows: Optional[int] = None) -> torch.Tensor:
    """Per ray (H, W) of the band, on ``mesh[0]``: whether it passes the
    bricks in ascending order (the z of its direction is not negative)."""
    rows = opts.height if n_rows is None else n_rows
    step = _init_rays(bricked.bricks[0].scene, opts, camera_x_offset, y_offset, rows)[3]
    return (step.z >= 0).reshape(rows, opts.width)


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
    band: dict            # the band of image rows (plain passes), {} for the whole image


def _forward(bricked: BrickedScene, opts: RenderOptions, camera_x_offset: float,
             fast: bool, y_offset: int = 0, n_rows: Optional[int] = None) -> _Forward:
    """The bricked forward of the whole image or, with ``n_rows``, of the
    band of ``n_rows`` rows from ``y_offset`` (the brick kernels and the
    plain passes both take one); every (H, W) is then (n_rows, W)."""
    band = {} if n_rows is None else dict(y_offset=y_offset, n_rows=n_rows)
    passes = ((cuda_bricks.brick_transmittance, cuda_bricks.brick_segment) if fast
              else (brick_march.transmittance_pass, brick_march.shaded_pass))
    transmittance, segment = (functools.partial(p, **band) for p in passes)
    relay = bricked.relay
    with torch.no_grad():
        ascending = _ascending(bricked, opts, camera_x_offset, **band)
        # every brick's pass is enqueued before the first copy between devices
        w_local, entry = zip(*(transmittance(brick, opts, camera_x_offset)
                               for brick in bricked.bricks))
        up_t = relay.upstream([1.0 - w for w in w_local], ascending, torch.cumprod, 1.0)
        w_in = [1.0 - t for t in up_t]
        own = [segment(brick, opts, camera_x_offset, w, entry=e)[0]
               for brick, w, e in zip(bricked.bricks, w_in, entry)]
        image = relay.image(own, ascending.device)
    return _Forward(image, ascending, w_in, own, list(entry), band)


def _backward(bricked: BrickedScene, opts: RenderOptions, camera_x_offset: float,
              g: torch.Tensor, fwd: _Forward, fast: bool) -> Dict:
    """The gradients for the pixel cotangent ``g`` (H, W, 3; the band's
    rows for a band's ``fwd``): grid keys as per-brick tensors shaped like
    the bricks' unpadded parts, on their devices; parameter keys summed over
    the bricks, on ``mesh[0]``."""
    dev0, relay = fwd.image.device, bricked.relay
    with torch.no_grad():
        g = g.to(dev0, torch.float32).contiguous()
        g_on = [g.to(brick.device) for brick in bricked.bricks]
        image_on = [fwd.image.to(brick.device) for brick in bricked.bricks]
        dots = [brick_march.own_dot(gb, own) for gb, own in zip(g_on, fwd.own)]
        up_dot = relay.upstream(dots, fwd.ascending, torch.cumsum, 0.0)
        segment_grads = functools.partial(
            cuda_bricks.brick_gradients if fast else brick_march.replay_pass, **fwd.band)
        per_brick = [segment_grads(brick, opts, camera_x_offset, gb, image, w, up, entry=e)
                     for brick, gb, image, w, up, e in zip(bricked.bricks, g_on, image_on,
                                                           fwd.w_in, up_dot, fwd.entry)]
        terms = {key: [p[key] for p in per_brick] for key in per_brick[0]}
        sums = relay.param_sums({k: v for k, v in terms.items() if k not in GRID_KEYS}, dev0)
        return {key: _fold(parts, relay) if key in GRID_KEYS else sums[key]
                for key, parts in terms.items()}


# ---------------------------------------------------------------------------
# plain entry points
# ---------------------------------------------------------------------------


def _forward_bands(scene: Scene, opts: RenderOptions, camera_x_offset: float, mesh
                   ) -> List[_Forward]:
    """The plain bricked forward of every band of ``mesh`` (``_band_meshes``);
    bands on the same devices share one split of the scene."""
    splits: Dict[Tuple[torch.device, ...], BrickedScene] = {}
    fwds = []
    for devices, y0, rows in _band_meshes(mesh, opts):
        if tuple(devices) not in splits:
            splits[tuple(devices)] = split_bricks(scene, devices)
        fwds.append(_forward(splits[tuple(devices)], opts, camera_x_offset, False, y0, rows))
    return fwds


def _joined(fwds: List[_Forward]) -> torch.Tensor:
    """The bands' images as one, on the first band's ``mesh[0]``."""
    dev = fwds[0].image.device
    return torch.cat([f.image.to(dev) for f in fwds])


def render_forward_bricked(scene: Union[Scene, BrickedScene], opts: RenderOptions,
                           camera_x_offset: float = 0.0, *, mesh: Optional[Mesh] = None
                           ) -> torch.Tensor:
    """Forward render with the volume cut along z over ``mesh``, in plain
    PyTorch on whatever devices the mesh names; (H, W, 3) on ``mesh[0]``
    (``mesh[0][0]`` for a rows x bricks mesh, which takes a ``Scene``).

    Agrees with the single-device render including the exact
    opacity-threshold early termination (the two-phase relay of the module
    docstring). Takes unlit and lit scenes (on-the-fly and lookup
    gradients). ``opts`` are the whole scene's.
    """
    cam = float(camera_x_offset)
    if _is_2d(mesh):
        if isinstance(scene, BrickedScene):
            raise TypeError("a rows x bricks mesh takes a Scene, not a BrickedScene")
        return _joined(_forward_bands(scene, opts, cam, mesh))
    return _forward(_as_bricked(scene, mesh), opts, cam, fast=False).image


class _RenderFusedBricked(torch.autograd.Function):
    """The bricked march forward, the per-brick replay backward."""

    @staticmethod
    def forward(ctx, template, opts, cam_off, mesh, keys, *leaves):
        scene = merge_scene(template, dict(zip(keys, leaves)))
        fwds = _forward_bands(scene, opts, cam_off, mesh)
        ctx.save_for_backward(*leaves)
        ctx.static = (template, opts, cam_off, mesh, keys, fwds)
        return _joined(fwds)

    @staticmethod
    def backward(ctx, g):
        template, opts, cam_off, mesh, keys, fwds = ctx.static
        leaves = ctx.saved_tensors
        scene = merge_scene(template, dict(zip(keys, leaves)))
        devices = {key: leaf.device for key, leaf in zip(keys, leaves)}
        total: Dict[str, torch.Tensor] = {}
        splits: Dict[Tuple[torch.device, ...], BrickedScene] = {}
        for (bricks_of_band, y0, rows), fwd in zip(_band_meshes(mesh, opts), fwds):
            if tuple(bricks_of_band) not in splits:
                splits[tuple(bricks_of_band)] = split_bricks(scene, bricks_of_band)
            grads = _backward(splits[tuple(bricks_of_band)], opts, cam_off, g[y0:y0 + rows], fwd,
                              fast=False)
            for key, value in grads.items():  # summed over the bands
                if key not in devices:
                    continue
                value = (assemble(value, devices[key]) if key in GRID_KEYS
                         else value.to(devices[key]))
                total[key] = value if key not in total else total[key] + value
        return (None,) * 5 + tuple(total[key] if need else None
                                   for key, need in zip(keys, ctx.needs_input_grad[5:]))


def render_fused_bricked(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0, *,
                         mesh: Mesh) -> torch.Tensor:
    """Differentiable bricked render (the drop-in for ``ops.vjp.render_fused``),
    (H, W, 3) on ``mesh[0]``, in plain PyTorch; ``mesh`` may be a rows x
    bricks mesh (``make_mesh_2d``), whose bands' gradients are summed.

    Forward: the two-phase bricked march. Backward: every brick replays its
    own samples with cotangents that see the whole ray, scatters into its
    halo-padded grids, the halo rows return to their owners and the
    parameters' gradients are summed over the bricks. Gradients reach every
    leaf of ``split_scene(scene)`` that requires grad, whole, on the leaf's
    device. Takes unlit and lit scenes.
    """
    diff, template = split_scene(scene)
    keys = tuple(diff)
    mesh = (tuple(tuple(check_mesh(row, "brick")) for row in mesh) if _is_2d(mesh)
            else tuple(_check_mesh(mesh)))
    return _RenderFusedBricked.apply(template, opts, float(camera_x_offset), mesh, keys,
                                     *(diff[k] for k in keys))


# ---------------------------------------------------------------------------
# entry points at kernel speed
# ---------------------------------------------------------------------------


def render_forward_bricked_fast(scene: Union[Scene, BrickedScene], opts: RenderOptions,
                                camera_x_offset: float = 0.0, *, mesh: Optional[Mesh] = None
                                ) -> torch.Tensor:
    """Bricked forward render with the brick kernel per brick: 2 launches a
    brick (phase 1, phase 2) on CUDA bricks, the plain passes on CPU bricks;
    (H, W, 3) on ``mesh[0]``. Any camera; unlit and lit scenes (on-the-fly
    and lookup gradients).
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
    parameters' gradients are summed over the bricks, on ``mesh[0]``; lit,
    ``reflection`` is filled and ``light_colors`` added; with lookup
    gradient volumes ``gradient_x``, ``gradient_y`` and ``gradient_z`` too,
    cut like emission (the lookup gradient segment).
    """
    bricked = _as_bricked(scene, mesh)
    cam = float(camera_x_offset)
    fwd = _forward(bricked, opts, cam, fast=True)
    return fwd.image, _voxel_grads(bricked, opts, g, cam, fwd)


def _fast_step(bricked: BrickedScene, opts: RenderOptions, target: torch.Tensor,
               camera_x_offset: float, y_offset: int = 0, n_rows: Optional[int] = None
               ) -> Tuple[torch.Tensor, Dict]:
    """The sum-of-squares loss of the bricked image (or of its band of
    ``n_rows`` rows from ``y_offset``) against the same rows of ``target``
    (H, W, 3), and its gradients (``_voxel_grads``) at kernel speed."""
    fwd = _forward(bricked, opts, camera_x_offset, fast=True, y_offset=y_offset, n_rows=n_rows)
    rows = target[y_offset:y_offset + fwd.image.shape[0]]
    resid = fwd.image - rows.to(fwd.image.device, torch.float32)
    return torch.sum(resid ** 2), _voxel_grads(bricked, opts, 2.0 * resid, camera_x_offset, fwd)


Params = Dict[str, Union[torch.Tensor, PerBrick]]


def split_params_bricked(scene: Scene, mesh: Mesh) -> Tuple[Params, BrickedScene]:
    """``scene`` as (trainable parameters, the bricked scene they go back
    into), the counterpart of ``train.split_params`` for a cut volume.

    ``emission`` and, unless aliased, ``absorption`` are lists of per-brick
    leaf tensors (D / B, H, W) on the bricks' devices; the three factors and
    the color are leaves on ``mesh[0]``. ``param_leaves`` lists them all for
    an optimizer."""
    mesh = _check_mesh(mesh)
    params = trainable_leaves(scene, len(mesh), range(len(mesh)), mesh)
    static = split_bricks(scene, mesh, grids={k: v for k, v in params.items()
                                              if k in GRID_KEYS})
    return params, static


def trainable_leaves(scene: Scene, n: int, indices: Sequence[int],
                     devices: Sequence[torch.device],
                     grids: Optional[Dict[str, PerBrick]] = None) -> Params:
    """The parameters of ``split_params_bricked`` for bricks ``indices`` of
    ``n``, brick ``indices[i]`` on ``devices[i]``: the grids as lists of
    per-brick leaves, the factors and the color as leaves on ``devices[0]``.
    ``grids`` (key -> the unpadded parts of bricks ``indices``) takes the
    place of the scene's own volumes of those keys, which then are not read."""
    grids = dict(grids or {})
    _check_divisible(scene, n, skip=tuple(grids))
    keys = ("emission",) + (() if scene.absorption_aliased else ("absorption",))
    parts = {}
    for key in keys:
        data = grids[key][0] if key in grids else getattr(scene, key).data
        if _is_whole(data):
            raise ValueError("a depth-1 volume is copied to every brick and cannot be trained cut")
        parts[key] = (list(grids[key]) if key in grids
                      else [data.chunk(n, dim=0)[b] for b in indices])

    def leaf(t, dev):
        return t.detach().to(dev, copy=True).requires_grad_(True)

    s = scene.settings
    params: Params = {key: [leaf(p, dev) for p, dev in zip(parts[key], devices)]
                      for key in keys}
    for key in ("factor_emission", "factor_absorption", "factor_reflection", "color"):
        params[key] = leaf(getattr(s, key), devices[0])
    return params


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every leaf tensor of ``params``, for ``torch.optim``."""
    leaves: List[torch.Tensor] = []
    for value in params.values():
        leaves.extend(value if isinstance(value, (list, tuple)) else [value])
    return leaves


def merge_params_bricked(params: Params, bricked: BrickedScene) -> BrickedScene:
    """``bricked`` with ``params`` in place of its own leaves: the grids'
    halos are exchanged anew, the factors and the color go to every brick."""
    padded = {key: _pad([part.detach() for part in params[key]], bricked.relay)
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
    return BrickedScene(tuple(bricks), bricked.relay)


def train_step_fast_bricked(params: Params, optimizer: torch.optim.Optimizer,
                            scene: Union[Scene, BrickedScene], opts: RenderOptions,
                            target: torch.Tensor, *, mesh: Optional[Mesh] = None,
                            camera_x_offset: float = 0.0) -> torch.Tensor:
    """One training step at kernel speed with the grids cut across the mesh
    (sum-of-squares loss): halo exchange, bricked forward, closed-form pixel
    cotangent, gradient segments with the halo rows folded back, the loss
    and the gradients summed over the bands of the relay (``Relay.band``;
    one process has one band, the whole image), optimizer. 3 launches a
    brick. Updates ``params`` in place and returns the loss
    before the update, on ``mesh[0]``.

    With the ``BrickedScene`` of ``split_params_bricked`` and its params
    (per-brick leaves, each on its device) the grids stay cut from end to
    end. With a ``Scene`` and the whole params of ``train.split_params``
    (the memory planner's bricked tier) the grids are cut for the step
    over ``mesh`` and their gradients joined on each leaf's device. Lit
    scenes train through the lit forms, with on-the-fly or lookup gradients."""
    cam = float(camera_x_offset)
    whole = not isinstance(scene, BrickedScene)
    if whole:
        if mesh is None:
            raise ValueError("a Scene with whole params needs the mesh to cut it over")
    elif mesh is not None:
        _as_bricked(scene, mesh)
    with torch.no_grad():
        if whole:
            merged = split_bricks(merge_scene(scene, {k: v.detach() for k, v in params.items()}),
                                  mesh)
        else:
            merged = merge_params_bricked(params, scene)
        loss, grads = _fast_step(merged, opts, target, cam, *merged.relay.band(opts))
        merged.relay.band_sum([loss] + [t for key in params for t in (
            grads[key] if isinstance(grads[key], list) else [grads[key]])])
        for key, value in params.items():
            if whole and key in GRID_KEYS:
                value.grad = assemble(grads[key], value.device).reshape(value.shape)
            elif isinstance(value, (list, tuple)):
                for p, grad in zip(value, grads[key]):
                    p.grad = grad.reshape(p.shape)
            else:
                value.grad = grads[key].reshape(value.shape).to(value.device)
    optimizer.step()
    return loss
