"""The z-slab sweep through the z-brick kernels' launch forms (K7): the card's
route of ``ops/slab.py``.

Slab s of n marches as brick s of n (``brick_march.Slab``): the owner rule,
the entry record and the three launch forms of ``ops/cuda_bricks.py`` are the
bricks', and only the grids differ. A slab's grids are the JAX package's
clamped windows, bd + 2 HALO rows from ``clip(s * bd - HALO, 0, D - rows)``:

- the slabbed tier (``render_forward_slabbed_fast``,
  ``voxel_grads_slabbed_fast``) passes views of the grids on the card, no
  copy;
- the streamed tier (``render_forward_streamed_fast``,
  ``streamed_grads_fast``) keeps the grids in pinned host memory and copies
  each window, one contiguous row range a role, into one of two device
  buffers a role on a side stream, so that slab s + 1 is copied while slab s
  marches.

Forward of slab s: phase 1 (``brick_transmittance``) for the entry record,
then phase 2 (``brick_segment``) from the opacity that the sweep carries;
the segment's colour is added and its exit opacity carried for the rays of
the sweep's direction alone. Rays of the other direction march in the same
launches with an entry opacity of 1, so they take at most their first
sample, and are masked out. Rays with dz >= 0 pass the slabs in ascending
order, the others in descending order, as in ``ops/slab.py``; the carried
opacity is the sequential one, so the early exit is the single-device
march's.

A sweep visits the slabs from the first that a ray of its direction can own
a sample in to the last, bounds taken from each ray's box entry and exit a
step and a margin beyond (``_Ranges``), and stops after the slab where every
ray of the direction has passed the opacity threshold or its last slab.

Backward of slab s (``brick_gradients``): the entry opacity and phase 1's
record are recomputed in the backward sweep (phase 1 and phase 2 again, a
slab at a time, from the forward's image), ``up_dot`` is the running sum of
``own_dot`` over the slabs before it in the ray's order, and the cotangent
is zero for rays of the other direction. The window-shaped gradients are
added to rows [z_off, z_off + rows) of the full gradient grids: on the card
for the slabbed tier, in host memory for the streamed one. Nothing is kept
per slab between the passes: the tiers exist where memory is short, and a
record a slab would cost 36 bytes a ray and slab.

On a CUDA device each form is one kernel launch; on the CPU the wrappers run
their plain passes (``ops/brick_march.py``), so the same sweep is tested
here. Lit scenes take the lit forms of phase 2 and of the gradient segment,
their windows those of reflection and, with lookup gradients, of the three
gradient volumes too (``ops.slab._role_volumes``), which phase 2 packs with
emission's window for each launch (``cuda_bricks.pack_window``): on the
stream that launches, so after a streamed window's copy, which that stream
waits for (``_Streamed.slab``). The backward sweep of such a scene takes the
lookup gradient segment, which reads the same packed window and returns the
three gradient windows' gradients beside emission's; they are added into
the whole grids as the others are (in host memory on the streamed tier).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import cuda_bricks
from volume_renderer_tpu_torch.ops.brick_march import Slab, own_dot
from volume_renderer_tpu_torch.ops.forward import _init_rays
from volume_renderer_tpu_torch.ops.slab import (
    _NAME_OF, _check_divisible, _role_volumes, _slab_window, placeholders, slab_of)
from volume_renderer_tpu_torch.ops.vjp import merge_scene, split_scene


@dataclasses.dataclass
class SweepStats:
    """What the last sweep did: the slabs it visited, in order, a list for
    each direction that had rays (a backward call's forward and backward
    sweeps in turn), and the streamed tier's host -> device copies."""

    tier: str
    n_slabs: int
    visited: List[List[int]] = dataclasses.field(default_factory=list)
    h2d_bytes: int = 0
    copies: list = dataclasses.field(default_factory=list)  # (start, end) CUDA events

    def h2d_ms(self) -> float:
        """The copies' time on their stream (waits for them)."""
        total = 0.0
        for start, end in self.copies:
            end.synchronize()
            total += start.elapsed_time(end)
        return total


LAST_SWEEP: Optional[SweepStats] = None

# the keys of a slab's gradients that are window-shaped grids
_GRID_KEYS = tuple(_NAME_OF.values())


class _Ranges:
    """Per ray: whether it passes the slabs in ascending order, and the first
    and last slab it can own a sample in. The bounds are taken in closed form
    at the ray's first step and one step beyond its last (the last before t
    passes tfar, plus one for the rounding of the accumulated t), each pushed
    by 1e-3 of the box outwards, so that they hold whatever the rounding of
    the kernels' accumulated positions."""

    # rays set up at once: the set-up's transients stay a few MiB
    _BAND_RAYS = 1 << 16

    def __init__(self, scene: Scene, opts: RenderOptions, camera_x_offset: float, n: int):
        rows = max(1, self._BAND_RAYS // opts.width)
        parts = [self._band(scene, opts, camera_x_offset, n, y0, min(rows, opts.height - y0))
                 for y0 in range(0, opts.height, rows)]
        self.ascending, self.first, self.last, self.hit = (torch.cat(p) for p in zip(*parts))

    @staticmethod
    def _band(scene, opts, camera_x_offset, n, y0, rows):
        with torch.no_grad():
            consts, _, pos0, step, tnear, tfar, hit = _init_rays(
                scene, opts, camera_x_offset, y0, rows)
            sign = torch.where(step.z >= 0, 1.0, -1.0)
            last = torch.clamp(torch.floor((tfar - tnear) / consts.tstep) + 1.0, 0.0,
                               opts.n_steps - 1.0)
            zmin, inv = consts.boxmin[2], consts.boxscale[2]

            def owner(z, push):
                zn = (z - zmin) * inv + push
                return torch.clamp(torch.floor(zn * n), 0, n - 1).to(torch.int32).reshape(
                    rows, opts.width)

            return ((step.z >= 0).reshape(rows, opts.width), owner(pos0.z, -1e-3 * sign),
                    owner(pos0.z + (last + 1.0) * step.z, 1e-3 * sign),
                    hit.reshape(rows, opts.width))

    def order(self, ascending: bool) -> List[int]:
        """The slabs a sweep visits, in its order; [] without rays."""
        rays = self.hit & (self.ascending if ascending else ~self.ascending)
        if not bool(rays.any()):
            return []
        first, last = self.first[rays], self.last[rays]
        if ascending:
            lo, hi = torch.stack([first.min(), last.max()]).tolist()
            return list(range(lo, hi + 1))
        hi, lo = torch.stack([first.max(), last.min()]).tolist()
        return list(range(hi, lo - 1, -1))

    def any_left(self, mask: torch.Tensor, w: torch.Tensor, threshold: torch.Tensor, s: int,
                 ascending: bool) -> bool:
        """Whether a ray of the sweep has a sample left after slab ``s``."""
        beyond = self.last > s if ascending else self.last < s
        return bool((self.hit & mask & (w <= threshold) & beyond).any())


class _Resident:
    """The slabs of grids on the march's device: views, no copy."""

    def __init__(self, scene: Scene, n: int):
        self.scene, self.n = scene, n

    def slab(self, s: int) -> Slab:
        return slab_of(self.scene, s, self.n)

    def prefetch(self, s: int) -> None:
        pass

    def release(self) -> None:
        pass

    def close(self) -> None:
        pass


def _pinned(t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    if t.device.type != "cpu" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError("a streamed grid must be a contiguous float32 CPU tensor, got "
                         f"{t.dtype} on {t.device}")
    return t if t.is_pinned() else t.pin_memory()


class _Streamed:
    """The slabs of host-resident grids: each window copied into one of two
    device buffers a role on a side stream, the next slab's while this one
    marches. Host grids that are not pinned are pinned once, here."""

    def __init__(self, scene: Scene, march: Scene, n: int, stats: SweepStats):
        """``scene``: the host-resident scene; ``march``: its
        ``ops.slab.placeholders`` on the device that marches."""
        self.host = {role: _pinned(data) for role, data in _role_volumes(scene).items()}
        self.scene, self.n, self.dev, self.stats = march, n, march.device, stats
        device = self.dev
        self.stream = torch.cuda.Stream(device)
        self.buffers = [{role: torch.empty((_slab_window(h.shape[0], n, 0)[1],) + h.shape[1:],
                                           dtype=torch.float32, device=device)
                         for role, h in self.host.items()} for _ in range(2)]
        self.held: List[Optional[int]] = [None, None]  # the slab in each buffer
        self.ready: List[Optional[torch.cuda.Event]] = [None, None]
        self.free: List[Optional[torch.cuda.Event]] = [None, None]
        self.current: Optional[int] = None

    def _load(self, s: int) -> int:
        if s in self.held:
            return self.held.index(s)
        i = 1 if self.current == 0 else 0  # never the buffer that marches
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.cuda.stream(self.stream):
            if self.free[i] is not None:  # its last slab's launches are done
                self.stream.wait_event(self.free[i])
            start.record(self.stream)
            for role, host in self.host.items():
                z0, rows = _slab_window(host.shape[0], self.n, s)
                self.buffers[i][role].copy_(host[z0:z0 + rows], non_blocking=True)
                self.stats.h2d_bytes += rows * host[0].numel() * 4
            end.record(self.stream)
        self.stats.copies.append((start, end))
        self.held[i], self.ready[i] = s, end
        return i

    def prefetch(self, s: int) -> None:
        self._load(s)

    def slab(self, s: int) -> Slab:
        i = self._load(s)
        torch.cuda.current_stream(self.dev).wait_event(self.ready[i])
        self.current = i
        return slab_of(self.scene, s, self.n, self.buffers[i])

    def release(self) -> None:
        """The launches of the current slab are enqueued: its buffer is free
        once they are done."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.dev))
        self.free[self.current] = event

    def close(self) -> None:
        torch.cuda.current_stream(self.dev).wait_stream(self.stream)


AddGrads = Callable[[Slab, Dict[str, torch.Tensor]], None]


def _sweep(windows, ranges: _Ranges, scene: Scene, opts: RenderOptions,
           camera_x_offset: float, stats: SweepStats, g: Optional[torch.Tensor] = None,
           image: Optional[torch.Tensor] = None, add: Optional[AddGrads] = None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The forward sweep (``g`` None): the image, on the scene's device. The
    backward sweep (``g``, the forward's ``image`` and ``add``): ``add``
    receives each slab's window-shaped grids; returns ``image`` and the
    parameters' gradients summed over the slabs."""
    dev = scene.device
    threshold = scene.settings.opacity_threshold
    shape = (opts.height, opts.width)
    out = torch.zeros(shape + (3,), dtype=torch.float32, device=dev) if g is None else image
    params: Dict[str, torch.Tensor] = {}
    for ascending in (True, False):
        order = ranges.order(ascending)
        if not order:
            continue
        mask = ranges.ascending if ascending else ~ranges.ascending
        w = torch.zeros(shape, dtype=torch.float32, device=dev)
        if g is not None:
            g_dir = torch.where(mask[..., None], g, 0.0).contiguous()
            up = torch.zeros(shape, dtype=torch.float32, device=dev)
        visited = []
        for k, s in enumerate(order):
            slab = windows.slab(s)
            if k + 1 < len(order):
                windows.prefetch(order[k + 1])
            visited.append(s)
            _, entry = cuda_bricks.brick_transmittance(slab, opts, camera_x_offset)
            w_in = torch.where(mask, w, 1.0).contiguous()
            # a lit lookup window's pack on the card, once for phase 2 and the
            # gradient segment
            packed = (cuda_bricks.pack_window(slab) if g is not None and dev.type == "cuda"
                      else None)
            contrib, w_out = cuda_bricks.brick_segment(slab, opts, camera_x_offset, w_in, entry,
                                                       packed=packed)
            if g is None:
                out += torch.where(mask[..., None], contrib, 0.0)
            else:
                grads = cuda_bricks.brick_gradients(slab, opts, camera_x_offset, g_dir, image,
                                                    w_in, up, entry, packed=packed)
                # the grids of the windows; a role the march does not sample
                # (an unlit scene's reflection) has a placeholder's zeros
                sampled = {_NAME_OF[role] for role in _role_volumes(slab.scene)}
                add(slab, {key: v for key, v in grads.items() if key in sampled})
                for key, value in grads.items():
                    if key not in _GRID_KEYS:
                        params[key] = value if key not in params else params[key] + value
                up = (up + own_dot(g_dir, contrib)).contiguous()
                # freed before the next slab's pack and gradient windows are
                # made (the planner counts one set: api/planner.py, tier_bytes)
                del packed, grads
            windows.release()
            w = torch.where(mask, w_out, w)
            if not ranges.any_left(mask, w, threshold, s, ascending):
                break
        stats.visited.append(visited)
    return out, params


def _param_zeros(scene: Scene) -> Dict[str, torch.Tensor]:
    """The parameters' gradients of a sweep in which no ray hit the box."""
    dev = scene.device
    out = {key: torch.zeros((3,) if key == "color" else (), dtype=torch.float32, device=dev)
           for key in ("factor_emission", "factor_absorption", "factor_reflection", "color")}
    if scene.has_lighting:
        out["light_colors"] = torch.zeros_like(scene.light_colors, dtype=torch.float32)
    return out


def _finish(stats: SweepStats, windows) -> None:
    global LAST_SWEEP
    windows.close()
    LAST_SWEEP = stats


def _cotangent(g, image: torch.Tensor) -> torch.Tensor:
    g = torch.as_tensor(g, dtype=torch.float32, device=image.device).contiguous()
    if tuple(g.shape) != tuple(image.shape):
        raise ValueError(f"g must be {tuple(image.shape)}, got {tuple(g.shape)}")
    return g


# ---- the slabbed tier: grids on the march's device ---------------------------


def render_forward_slabbed_fast(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0,
                                *, n_slabs: int) -> torch.Tensor:
    """Forward render sweeping the scene's grids in ``n_slabs`` z-slabs, 2
    launches a slab visited and direction (K7 phase 1 and phase 2) on a CUDA
    scene, the plain passes on a CPU one; (H, W, 3) on the scene's device.
    Each slab's grids are views of the scene's. Lit scenes take the lit
    phase 2."""
    _check_divisible(scene, n_slabs)
    stats = SweepStats("slabbed", n_slabs)
    windows = _Resident(scene, n_slabs)
    cam = float(camera_x_offset)
    with torch.no_grad():
        image, _ = _sweep(windows, _Ranges(scene, opts, cam, n_slabs), scene, opts, cam, stats)
    _finish(stats, windows)
    return image


def voxel_grads_slabbed_fast(scene: Scene, opts: RenderOptions, g, camera_x_offset: float = 0.0,
                             image: Optional[torch.Tensor] = None, *, n_slabs: int
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The slabbed sweep's backward: ``(image, grads)`` with the keys of
    ``ops.cuda_grads.voxel_grads_fast``; the grids whole, on the scene's
    device. 3 launches a slab visited and direction (phase 1 and 2 again, the
    gradient segment) after the forward's 2, or without it when ``image``
    (``render_forward_slabbed_fast``'s own) is given. Lit scenes take the lit
    forms, with lookup gradient volumes the lookup gradient segment (their
    three gradients among the grids)."""
    _check_divisible(scene, n_slabs)
    cam = float(camera_x_offset)
    if image is None:
        image = render_forward_slabbed_fast(scene, opts, cam, n_slabs=n_slabs)
    stats = SweepStats("slabbed", n_slabs)
    windows = _Resident(scene, n_slabs)
    with torch.no_grad():
        g = _cotangent(g, image)
        grids = {_NAME_OF[r]: torch.zeros_like(v) for r, v in _role_volumes(scene).items()}

        def add(slab, window_grads):
            for key, value in window_grads.items():
                z0, _ = slab.slab_geometry(value)
                grids[key][z0:z0 + value.shape[0]] += value

        _, params = _sweep(windows, _Ranges(scene, opts, cam, n_slabs), scene, opts, cam, stats,
                           g, image, add)
    _finish(stats, windows)
    if not scene.reflection_aliased and "reflection" not in grids:  # unlit: not sampled
        grids["reflection"] = torch.zeros_like(scene.reflection.data)
    grids.update(params or _param_zeros(scene))
    return image, grids


# ---- the streamed tier: grids in host memory --------------------------------------


def _stream_device(scene: Scene, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the streamed sweep copies slabs to a CUDA device, not {dev}: "
                         "ops.slab.render_forward_streamed marches on the CPU")
    return dev


def render_forward_streamed_fast(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0,
                                 *, n_slabs: int, device: DeviceLike = None) -> torch.Tensor:
    """Forward render of a scene whose grids are CPU tensors, in ``n_slabs``
    z-slabs on the CUDA ``device`` (default: the card): a window of each
    role a slab on the card, 2 launches a slab visited and direction.
    Returns (H, W, 3) on ``device``."""
    dev = _stream_device(scene, device)
    _check_divisible(scene, n_slabs)
    cam = float(camera_x_offset)
    stats = SweepStats("streamed", n_slabs)
    with torch.no_grad():
        # the rays' bounds first: their set-up's transients stay below the buffers
        march = placeholders(scene, dev)
        ranges = _Ranges(march, opts, cam, n_slabs)
        windows = _Streamed(scene, march, n_slabs, stats)
        image, _ = _sweep(windows, ranges, march, opts, cam, stats)
    _finish(stats, windows)
    return image


def streamed_grads_fast(scene: Scene, opts: RenderOptions, g, *, n_slabs: int,
                        camera_x_offset: float = 0.0, g_fn=None, device: DeviceLike = None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``ops.slab.streamed_grads`` on the card: the streamed forward, then the
    backward sweep, a slab at a time; ``(grads, image)``, the sampled grids'
    gradients (emission and, unless aliased, absorption and, lit, reflection
    and any lookup gradient volume) as CPU tensors, the parameters' and the
    image on ``device``. Each window is copied to the card twice (forward and
    backward)."""
    dev = _stream_device(scene, device)
    _check_divisible(scene, n_slabs)
    cam = float(camera_x_offset)
    stats = SweepStats("streamed", n_slabs)
    with torch.no_grad():
        march = placeholders(scene, dev)
        ranges = _Ranges(march, opts, cam, n_slabs)
        windows = _Streamed(scene, march, n_slabs, stats)
        image, _ = _sweep(windows, ranges, march, opts, cam, stats)
        g = _cotangent(g_fn(image) if g is None else g, image)
        grids = {_NAME_OF[r]: torch.zeros(v.shape, dtype=torch.float32)
                 for r, v in windows.host.items()}

        def add(slab, window_grads):
            for key, value in window_grads.items():
                z0, _ = slab.slab_geometry(value)
                grids[key][z0:z0 + value.shape[0]] += value.cpu()

        _, params = _sweep(windows, ranges, march, opts, cam, stats, g, image, add)
    _finish(stats, windows)
    grids.update(params or _param_zeros(march))
    return grids, image


class _RenderFusedSlabbedFast(torch.autograd.Function):
    """The slabbed sweep forward, its backward sweep as the backward."""

    @staticmethod
    def forward(ctx, template, opts, cam_off, n_slabs, keys, *leaves):
        scene = merge_scene(template, dict(zip(keys, (t.detach() for t in leaves))))
        out = render_forward_slabbed_fast(scene, opts, cam_off, n_slabs=n_slabs)
        ctx.save_for_backward(out, *leaves)
        ctx.static = (template, opts, cam_off, n_slabs, keys)
        return out

    @staticmethod
    def backward(ctx, g):
        template, opts, cam_off, n_slabs, keys = ctx.static
        out, *leaves = ctx.saved_tensors
        scene = merge_scene(template, dict(zip(keys, leaves)))
        _, grads = voxel_grads_slabbed_fast(scene, opts, g, cam_off, image=out, n_slabs=n_slabs)
        return (None,) * 5 + tuple(grads[key].to(leaf.device) if need else None
                                   for key, leaf, need in zip(keys, leaves,
                                                              ctx.needs_input_grad[5:]))


def render_fused_slabbed_fast(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0,
                              *, n_slabs: int) -> torch.Tensor:
    """Differentiable slabbed sweep through the K7 launch forms (the kernel
    route of ``ops.slab.render_fused_slabbed``): ``render_forward_slabbed_fast``
    forward, ``voxel_grads_slabbed_fast`` backward. Gradients reach every
    leaf of ``split_scene(scene)`` that requires grad, a lit lookup scene's
    gradient volumes among them."""
    _check_divisible(scene, n_slabs)
    diff, template = split_scene(scene)
    keys = tuple(diff)
    return _RenderFusedSlabbedFast.apply(template, opts, float(camera_x_offset), int(n_slabs),
                                         keys, *(diff[k] for k in keys))
