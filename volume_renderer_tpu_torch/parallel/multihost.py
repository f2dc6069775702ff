"""Several processes over ``torch.distributed`` (port of
``volume_renderer_tpu.parallel.multihost``).

The JAX package joins N processes into one device namespace with
``jax.distributed.initialize`` and runs its ``shard_map`` paths over a mesh
of every host's devices. The port's counterpart is a process group: every
process runs the same program on one device, a card or the CPU, and the
collectives are NCCL's between cards and gloo's on the CPU.

- ``initialize`` joins this process to the group
  (``torch.distributed.init_process_group``). With no arguments it takes its
  rank, world size and address from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), as JAX
  detects them on a pod; a cluster without a launcher passes them.
- ``global_mesh`` is the group's rank-to-device layout: the device of each
  rank, in rank order.
- Rays-DP across ranks: rank r marches band r of the image rows
  (``parallel.sharding.bands``: the bands that ``MarchArgs.row0`` and
  ``image_height`` march, a launch of the forward kernel a band).
  ``render_forward_dp`` joins the bands with ``all_gather``. The training
  steps, ``train_step_dp`` (autograd over the plain band loss, the
  counterpart of ``train.train_step_sharded``) and ``train_step_fast_dp``
  (the kernels: K1 + K3 unlit, K4 + K6 lit; ``train_step_fast_sharded``'s),
  ``all_reduce`` the loss and every gradient with SUM, and every rank then
  takes the same optimizer step on its own copy of the parameters, so the
  copies stay equal. A gloo group reduces a card's tensors through host
  copies.
- The z-brick relay across ranks: rank r of W holds brick r of W, z-rows
  [r * D / W, (r + 1) * D / W) of every grid and ``HALO`` rows of each
  neighbour's, and marches it with the brick passes of
  ``parallel/bricks.py`` (the K7 kernels on a card, the plain passes on the
  CPU). ``GroupRelay`` takes the place of the one process's device lists
  (``bricks.Relay``) at the six points where bricks meet. What crosses the
  group, a rank's share: the halo rows, sent to and received from ranks
  r - 1 and r + 1 (``batch_isend_irecv``), on the cut and, as gradients,
  back to their owners; phase 1's (H, W) opacities and the backward's
  (H, W) contribution dots, ``all_gather``ed, then scanned on each rank as
  on one process; the (H, W, 3) contributions, ``all_gather``ed and summed
  in brick order, so that every rank holds the one-process image to the
  bit; the parameters' gradients (factors, color, ``light_colors``) and a
  depth-1 volume's, ``all_reduce``d with SUM. The whole volume is never
  gathered (but by ``render_fused_bricked_ranks``'s backward, whose grid
  leaves are whole), and a rank need never hold it: ``split_brick_rank``
  and ``split_params_bricked_rank`` take the rank's own rows (``grids=``).
  Entry points, the one-process names with ``_ranks``:
  ``split_brick_rank``, ``render_forward_bricked_ranks``,
  ``voxel_grads_bricked_ranks``, ``split_params_bricked_rank`` and
  ``train_step_fast_bricked_ranks``, ``render_fused_bricked_ranks``.
- The rows x bricks mesh across ranks (the JAX package's bricked paths with
  ``ray_axis=`` on a process-spanning mesh): every entry point above takes
  ``mesh=global_mesh_2d(R, B)`` (a ``RankMesh``; None is 1 x W, the relay
  above). Rank k is (r, b) = ``divmod(k, B)``; it holds brick b of B and
  marches band r of the image rows, [r H / R, (r + 1) H / R), with the K7
  kernels over that band alone. The bricks meet within the band's group
  of B ranks (``GroupRelay(band_group, mesh)``: the halo rows, the band's
  opacities, dots and contributions); the bands meet within the brick's
  group of R ranks: the band images ``all_gather``ed and joined in band
  order (every rank returns the whole image), the loss and every gradient
  ``all_reduce``d (a grid's part summed over the bands, which the JAX
  package's 2-D backward leaves out), so the R ranks of a brick hold the
  same part and every rank the same parameters.
- ``run_demo`` rehearses either: it spawns N processes
  (``torch.multiprocessing``, joined through a ``file://`` store in a
  temporary directory, so parallel test workers never share a port) that
  render and train the lit flagship scene rays-DP, or (``bricks=``, the
  CLI's ``--bricks``) render and train the flagship shell's cases a brick a
  rank, each rank building its own rows alone, and checks that every rank
  holds the same images, losses and replicated values. Run as a module::

      python -m volume_renderer_tpu_torch.parallel.multihost --demo --device cpu
      python -m volume_renderer_tpu_torch.parallel.multihost --demo --bricks \
          --num-processes 4 [--bands 2] [--backend gloo] [--full]

  (``--bands R``: R x num-processes / R ranks, rank (r, b) marching brick b
  over band r.) On the cards the bricked rehearsal also prints, as one JSON
  line, each rank's forward and step ms and peak MiB beside one process
  driving the same bricks over the whole image (``one_process_ms``).
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import cuda_bricks
from volume_renderer_tpu_torch.ops.brick_march import HALO, Brick
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.cuda_march import render_rows_fast
from volume_renderer_tpu_torch.ops.vjp import GRID_KEYS, merge_scene, split_scene
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.sharding import bands
from volume_renderer_tpu_torch.train import Params, band_loss, merge_params

_ENV_DOC = """A process group over several hosts or cards: start one process a
card with torchrun (every process then calls initialize() with no
arguments), or pass each process the group's address ("host:port" or a
file:// or tcp:// URL), its size and its rank."""


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: DeviceLike = None,
               backend: Optional[str] = None) -> torch.device:
    """Joins this process to the process group and returns the device it
    marches on.

    ``coordinator_address``: "host:port" (a TCP store on rank 0), or a
    ``tcp://`` or ``file://`` URL; None reads ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``env://``). ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``. ``device``: None is card
    ``LOCAL_RANK`` (else the rank) modulo the cards on the host; "cpu" asks
    for the CPU. ``backend``: NCCL for a card and gloo for the CPU unless
    named; gloo also takes a card's ranks (through host copies), which is
    how two ranks share one card, where NCCL puts one rank on a card."""
    if dist.is_initialized():
        raise RuntimeError("this process is already in a process group")
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a group of {world}")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no card, and the CPU was not asked for
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)
    return dev


def global_mesh(device: torch.device) -> List[torch.device]:
    """The device of every rank, in rank order (``device``: this rank's, as
    ``initialize`` returned it); a device of another host is named as that
    host names it."""
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(device))
    return [torch.device(name) for name in names]


def _on_host(t: torch.Tensor, group=None) -> bool:
    """Whether a collective over ``t`` runs on a host copy: gloo reduces and
    gathers CPU tensors."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> None:
    """Sums each float32 tensor over the ranks of ``group`` (None: every
    rank), in place, in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat.cpu() if _on_host(flat, group) else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if buf is not flat:
        flat.copy_(buf)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].reshape(t.shape))
        offset += t.numel()


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """``t`` of every rank of ``group`` (None: every rank), in the group's
    rank order, on ``t``'s device."""
    buf = t.contiguous()
    buf = buf.cpu() if _on_host(buf, group) else buf
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return [p.to(t.device) for p in parts]


def my_band(opts: RenderOptions) -> tuple:
    """(first row, rows) of this rank's band of image rows."""
    return bands(opts.height, dist.get_world_size())[dist.get_rank()]


def _band_image(scene: Scene, opts: RenderOptions, camera_x_offset: float) -> torch.Tensor:
    """This rank's band of the forward render: one launch of the forward
    kernel on a card (the plain march on the CPU); (rows, W, 3)."""
    y0, rows = my_band(opts)
    if rows == 0:
        return torch.zeros((0, opts.width, 3), dtype=torch.float32, device=scene.device)
    return render_rows_fast(scene, opts, camera_x_offset, y0, rows)


def render_forward_dp(scene: Scene, opts: RenderOptions,
                      camera_x_offset: float = 0.0) -> torch.Tensor:
    """Rays-DP forward render across the ranks: this rank's band, then
    ``all_gather`` of every band (padded to the longest); the whole image
    (H, W, 3) on every rank, equal to ``render_forward_fast``'s bit for bit."""
    band = _band_image(scene, opts, camera_x_offset)
    longest = bands(opts.height, dist.get_world_size())[0][1]
    padded = torch.zeros((longest, opts.width, 3), dtype=torch.float32, device=band.device)
    padded[:band.shape[0]] = band
    buf = padded.cpu() if _on_host(padded) else padded
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    return torch.cat(parts)[:opts.height].to(band.device)


def _finish_step(params: Params, optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                 grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sums the band's loss and gradients over the ranks, hands the sums to
    the parameters and steps the optimizer; returns the image's loss."""
    keys = list(params)
    total = [loss.reshape(1).to(torch.float32)] + [grads[k].to(torch.float32) for k in keys]
    all_reduce_sum(total)
    for key, value in zip(keys, total[1:]):
        params[key].grad = value.reshape(params[key].shape)
    optimizer.step()
    return total[0].reshape(())


def train_step_dp(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                  opts: RenderOptions, target: torch.Tensor) -> torch.Tensor:
    """``train.train_step_sharded`` across the ranks: this rank's band loss
    (``train.band_loss`` with the fixed trip count) through
    ``torch.autograd``, the loss and gradients summed over the ranks, one
    optimizer step on every rank. ``params``: this rank's copy, on its
    device; returns the image's loss before the update."""
    y0, rows = my_band(opts)
    optimizer.zero_grad(set_to_none=True)
    target = target.to(torch.float32)
    if rows:
        loss = band_loss(params, scene, opts, target[y0:y0 + rows].to(scene.device), y0, rows,
                         early_exit=False)
        loss.backward()
    else:
        loss = torch.zeros((), device=scene.device)
    with torch.no_grad():
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        return _finish_step(params, optimizer, loss.detach(), grads)


def train_step_fast_dp(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                       opts: RenderOptions, target: torch.Tensor,
                       camera_x_offset: float = 0.0) -> torch.Tensor:
    """``parallel.pallas_dp.train_step_fast_sharded`` across the ranks: the
    forward kernel and the scatter kernel over this rank's band (K1 + K3
    unlit, K4 + K6 lit, K5 + K6L lit with lookup gradient volumes; their
    plain versions on the CPU), the closed-form
    cotangent ``2 (img - target)``, the loss and gradients summed over the
    ranks, one optimizer step on every rank. Returns the image's loss
    before the update."""
    y0, rows = my_band(opts)
    with torch.no_grad():
        merged = merge_params(params, scene)
        img = _band_image(merged, opts, camera_x_offset)
        resid = img - target[y0:y0 + rows].to(img.device, torch.float32)
        loss = torch.sum(resid ** 2)
        if rows:
            _, grads = voxel_grads_fast(merged, opts, 2.0 * resid, camera_x_offset, image=img,
                                        y_offset=y0, n_rows=rows)
        else:
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
        return _finish_step(params, optimizer, loss, grads)


# ---------------------------------------------------------------------------
# the z-brick relay across ranks
# ---------------------------------------------------------------------------


class GroupRelay(bricks.Relay):
    """``bricks.Relay`` over a process group (``group``; None: every rank):
    rank r of the group's W holds brick r of W, and every step where the
    bricks meet is a collective over the group (the JAX package's
    ``ppermute``, ``all_gather`` and ``psum`` over the brick axis). Its
    per-brick lists hold the rank's one brick. On a rows x bricks mesh
    the group is a band's ranks, and ``mesh`` (a ``RankMesh``) gives the
    band's rows (``band``) and sums over the bands (``band_sum``:
    ``all_reduce`` over the brick group).

    - the halo rows, in and back: send and receive with ranks r - 1 and
      r + 1 (``batch_isend_irecv``);
    - phase 1's opacities and the backward's contribution dots:
      ``all_gather`` of the (H, W) planes, then the same two scans as on
      one process (``bricks._upstream``), on this rank;
    - the image: ``all_gather`` of the contributions, summed in brick order
      on every rank, so that it is the one-process image to the bit (the
      gradient segments read it; an ``all_reduce`` sums in its own order);
    - the parameters' gradients and a depth-1 volume's: ``all_reduce`` SUM.

    A gloo group moves a card's tensors through host copies."""

    def __init__(self, group=None, mesh: Optional["RankMesh"] = None):
        self.group, self.mesh = group, mesh
        self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)

    def _peer(self, i: int) -> int:
        """The global rank of the group's rank ``i``."""
        return i if self.group is None else dist.get_global_rank(self.group, i)

    def _exchange(self, to_prev: torch.Tensor, to_next: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sends ``to_prev`` to the group's rank r - 1 and ``to_next`` to its
        rank r + 1, and returns what those two sent this rank (zeros where
        there is no such rank)."""
        dev = to_next.device
        host = _on_host(to_next, self.group)
        to_prev, to_next = (t.contiguous().cpu() if host else t.contiguous()
                            for t in (to_prev, to_next))
        from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
        ops = []
        for peer, send, recv in ((self.rank - 1, to_prev, from_prev),
                                 (self.rank + 1, to_next, from_next)):
            if 0 <= peer < self.world:
                ops += [dist.P2POp(dist.isend, send, self._peer(peer), self.group),
                        dist.P2POp(dist.irecv, recv, self._peer(peer), self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_prev.to(dev), from_next.to(dev)

    def with_halo(self, parts):
        (own,) = parts
        lo, hi = self._exchange(own[:HALO], own[-HALO:])
        return [torch.cat([lo, own, hi], dim=0)]

    def return_halo(self, padded):
        (grad,) = padded
        from_prev, from_next = self._exchange(grad[:HALO], grad[-HALO:])
        center = grad[HALO:-HALO].clone()
        if self.rank < self.world - 1:  # the next rank's low halo holds my last rows
            center[-HALO:] += from_next
        if self.rank > 0:
            center[:HALO] += from_prev
        return [center]

    def whole_sum(self, grads):
        (grad,) = grads
        total = grad.clone()
        all_reduce_sum([total], self.group)
        return [total]

    def upstream(self, values, ascending, scan, identity):
        (value,) = values
        gathered = all_gather(value, self.group)
        return [bricks._upstream(gathered, ascending, scan, identity)[self.rank]]

    def image(self, own, device):
        (contribution,) = own
        return super().image(all_gather(contribution, self.group), device)

    def param_sums(self, parts, device):
        total = {key: terms[0].to(device, torch.float32).clone() for key, terms in parts.items()}
        all_reduce_sum(list(total.values()), self.group)
        return total

    def band(self, opts):
        return (0, None) if self.mesh is None else self.mesh.rows(opts)

    def band_sum(self, tensors):
        if self.mesh is not None:
            self.mesh.sum_bands(tensors)

    def whole(self, part: torch.Tensor) -> torch.Tensor:
        """The whole grid from every rank's part (a depth-1 volume is whole
        already)."""
        return part if bricks._is_whole(part) else torch.cat(all_gather(part, self.group))


class RankMesh(NamedTuple):
    """The rows x bricks layout of the process group, the port's
    process-spanning ``Mesh(devices.reshape(n_bands, n_bricks), ("rays",
    "bricks"))``: rank k is (band, brick) = ``divmod(k, n_bricks)``, the
    order of ``parallel.mesh.make_mesh_2d``. Rank (r, b) holds brick b of
    ``n_bricks`` and marches band r of ``n_bands`` of the image rows
    (``rows``). ``band_group`` holds band r's ``n_bricks`` ranks, over
    which the bricks meet (``relay``); ``brick_group`` the ``n_bands`` ranks
    that hold brick b, over which the bands are joined and the gradients
    summed. ``global_mesh_2d`` makes it; a group of None is every rank."""

    n_bands: int
    n_bricks: int
    band: int
    brick: int
    band_group: Optional[dist.ProcessGroup]
    brick_group: Optional[dist.ProcessGroup]

    def rows(self, opts: RenderOptions) -> Tuple[int, int]:
        """(first row, rows) of this rank's band: [r H / R, (r + 1) H / R)."""
        if opts.height % self.n_bands != 0:
            raise ValueError(f"image height {opts.height} must be divisible by the ray axis "
                             f"size {self.n_bands}")
        rows = opts.height // self.n_bands
        return self.band * rows, rows

    def relay(self) -> GroupRelay:
        """The relay of this rank's band, whose brick b of ``n_bricks`` it holds."""
        return GroupRelay(self.band_group, self)

    def join_bands(self, band_image: torch.Tensor) -> torch.Tensor:
        """The whole image from every band's, on every rank: ``all_gather``
        over the brick group, joined in band order."""
        if self.n_bands == 1:
            return band_image
        return torch.cat(all_gather(band_image, self.brick_group))

    def sum_bands(self, tensors: List[torch.Tensor]) -> None:
        """Sums each float32 tensor over the bands, in place: ``all_reduce``
        over the brick group."""
        if self.n_bands > 1:
            all_reduce_sum(tensors, self.brick_group)


def global_mesh_2d(n_bands: int, n_bricks: int) -> RankMesh:
    """The group's ``n_bands`` x ``n_bricks`` layout (``RankMesh``). Every
    rank calls it with the same sizes: it makes every band's and every
    brick's process group, in the same order on every rank. Raises
    ``ValueError`` unless the group has ``n_bands * n_bricks`` ranks."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_bands < 1 or n_bricks < 1 or n_bands * n_bricks != world:
        raise ValueError(f"a rows x bricks mesh of {n_bands} x {n_bricks} does not cover the "
                         f"group's {world} ranks")
    band, brick = divmod(rank, n_bricks)
    band_groups = [dist.new_group([r * n_bricks + b for b in range(n_bricks)])
                   for r in range(n_bands)]
    brick_groups = [dist.new_group([r * n_bricks + b for r in range(n_bands)])
                    for b in range(n_bricks)]
    return RankMesh(n_bands, n_bricks, band, brick, band_groups[band], brick_groups[brick])


def _layout(mesh: Optional[RankMesh]) -> RankMesh:
    """``mesh``, checked against this rank; None is 1 x W over every rank: a
    brick a rank, each marching the whole image."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh is None:
        return RankMesh(1, world, 0, rank, None, None)
    if (mesh.n_bands * mesh.n_bricks != world
            or divmod(rank, mesh.n_bricks) != (mesh.band, mesh.brick)):
        raise ValueError(f"band {mesh.band} and brick {mesh.brick} of {mesh.n_bands} x "
                         f"{mesh.n_bricks} are not rank {rank}'s of {world}")
    return mesh


def split_brick_rank(scene: Scene, grids: Optional[Dict[str, torch.Tensor]] = None, *,
                     mesh: Optional[RankMesh] = None) -> Brick:
    """This rank's brick of ``scene``: brick b of B (of ``mesh``; None: b
    the rank, B the world), z-rows [b * D / B, (b + 1) * D / B) of every
    grid, on the scene's device.

    ``grids`` (key -> this rank's unpadded part, (D / B, H, W)) takes the
    place of the scene's own volumes of those keys, which then are not read.
    The halo rows always come from the ranks of the neighbouring bricks in
    this rank's band. Depth-1 volumes are whole on every rank. Every rank
    calls it with the same keys."""
    relay = _layout(mesh).relay()
    grids = dict(grids or {})
    bricks._check_divisible(scene, relay.world, skip=tuple(grids))
    dev = scene.device
    padded = {}
    for key in GRID_KEYS:
        vol = getattr(scene, key)
        if key in grids:
            part = grids[key].detach()
        elif vol is not None:
            data = vol.data.detach()
            part = (data if bricks._is_whole(data)
                    else data.chunk(relay.world, dim=0)[relay.rank]).to(dev)
        else:
            continue
        padded[key] = bricks._pad([part], relay)[0]
    return bricks.brick_of(scene, padded, relay.rank, relay.world, dev)


def _rank_bricked(scene_or_brick: Union[Scene, Brick], layout: RankMesh) -> bricks.BrickedScene:
    if not isinstance(scene_or_brick, Brick):
        scene_or_brick = split_brick_rank(scene_or_brick, mesh=layout)
    if (scene_or_brick.index, scene_or_brick.n) != (layout.brick, layout.n_bricks):
        raise ValueError(f"brick {scene_or_brick.index} of {scene_or_brick.n} is not this "
                         f"rank's: rank {dist.get_rank()} of {dist.get_world_size()} holds "
                         f"brick {layout.brick} of {layout.n_bricks}")
    return bricks.BrickedScene((scene_or_brick,), layout.relay())


def render_forward_bricked_ranks(scene_or_brick: Union[Scene, Brick], opts: RenderOptions,
                                 camera_x_offset: float = 0.0, *,
                                 mesh: Optional[RankMesh] = None) -> torch.Tensor:
    """``bricks.render_forward_bricked_fast`` across the ranks: this rank
    marches its brick over its band (2 launches of the brick kernels on a
    card, the plain passes on the CPU), the band's image is its bricks'
    contributions gathered and summed in brick order, the bands are joined,
    and every rank returns the image (H, W, 3). Takes a ``Scene`` (cut on
    every call) or this rank's ``Brick`` (``split_brick_rank``); ``mesh`` a
    ``RankMesh`` (None: a brick a rank, over the whole image)."""
    layout = _layout(mesh)
    fwd = bricks._forward(_rank_bricked(scene_or_brick, layout), opts, float(camera_x_offset),
                          True, *layout.rows(opts))
    return layout.join_bands(fwd.image)


def voxel_grads_bricked_ranks(scene_or_brick: Union[Scene, Brick], opts: RenderOptions, g,
                              camera_x_offset: float = 0.0, *,
                              mesh: Optional[RankMesh] = None) -> Tuple[torch.Tensor, Dict]:
    """``bricks.voxel_grads_bricked_fast`` across the ranks, 3 launches a
    rank: ``(image, grads)`` for the cotangent ``g`` (H, W, 3) of the whole
    image, of which the rank takes its band's rows. The grid keys are this
    rank's part (D / B, H, W), the halo rows returned within the band, then
    summed over the bands; the parameter keys are summed over the band's
    bricks, then over the bands; the same on every rank of a brick. A lit
    scene with lookup gradient volumes also gets the three gradient grids'
    parts (the lookup gradient segment)."""
    layout = _layout(mesh)
    bricked = _rank_bricked(scene_or_brick, layout)
    cam = float(camera_x_offset)
    y0, rows = layout.rows(opts)
    fwd = bricks._forward(bricked, opts, cam, True, y0, rows)
    image = layout.join_bands(fwd.image)
    g = torch.as_tensor(g, dtype=torch.float32, device=image.device)
    if tuple(g.shape) != tuple(image.shape):
        raise ValueError(f"g must be {tuple(image.shape)}, got {tuple(g.shape)}")
    grads = bricks._voxel_grads(bricked, opts, g[y0:y0 + rows], cam, fwd)
    grads = {k: v[0] if k in GRID_KEYS else v for k, v in grads.items()}
    layout.sum_bands(list(grads.values()))
    return image, grads


def split_params_bricked_rank(scene: Scene, grids: Optional[Dict[str, torch.Tensor]] = None, *,
                              mesh: Optional[RankMesh] = None) -> Tuple[Params, Brick]:
    """``bricks.split_params_bricked`` for this rank: the emission grid and,
    unless aliased, the absorption grid as leaves of this rank's part
    (D / B, H, W; brick b of ``mesh``); the factors and the color as leaves
    of their own, the same on every rank; and this rank's brick, which they
    go back into. ``grids`` as in ``split_brick_rank``: with every grid key
    given, the rank never holds more than its part."""
    layout = _layout(mesh)
    dev = scene.device
    grids = dict(grids or {})
    params = {k: v[0] if k in GRID_KEYS else v for k, v in bricks.trainable_leaves(
        scene, layout.n_bricks, [layout.brick], [dev],
        grids={k: [v] for k, v in grids.items()}).items()}
    brick = split_brick_rank(scene, grids={**grids, **{k: v for k, v in params.items()
                                                       if k in GRID_KEYS}}, mesh=layout)
    return params, brick


def train_step_fast_bricked_ranks(params: Params, optimizer: torch.optim.Optimizer,
                                  brick: Brick, opts: RenderOptions, target: torch.Tensor,
                                  camera_x_offset: float = 0.0, *,
                                  mesh: Optional[RankMesh] = None) -> torch.Tensor:
    """``bricks.train_step_fast_bricked`` across the ranks, with the params
    and brick of ``split_params_bricked_rank``: the halo rows exchanged
    within the band, the bricked forward of the band, the cotangent of the
    sum-of-squares loss on the band's rows of ``target`` (H, W, 3), this
    rank's gradient segment with the halo rows returned, the parameters'
    gradients summed over the band's bricks, then the loss and every
    gradient summed over the bands, then this rank's optimizer. Every rank
    takes the same step on its replicated leaves and the ranks of a brick on
    its part, so they stay equal. 3 launches a rank; lit scenes through the
    lit forms. Returns the image's loss before the update, the same on every
    rank."""
    cut = {k: [v] if k in GRID_KEYS else v for k, v in params.items()}
    return bricks.train_step_fast_bricked(cut, optimizer, _rank_bricked(brick, _layout(mesh)),
                                          opts, target, camera_x_offset=camera_x_offset)


class _RenderFusedRanks(torch.autograd.Function):
    """The bricked march forward, the per-brick replay backward, a brick
    and band a rank."""

    @staticmethod
    def forward(ctx, template, opts, cam_off, layout, keys, *leaves):
        bricked = _rank_bricked(merge_scene(template, dict(zip(keys, leaves))), layout)
        fwd = bricks._forward(bricked, opts, cam_off, False, *layout.rows(opts))
        ctx.static = (bricked, opts, cam_off, layout, keys, fwd, [leaf.device for leaf in leaves])
        return layout.join_bands(fwd.image)

    @staticmethod
    def backward(ctx, g):
        bricked, opts, cam_off, layout, keys, fwd, devices = ctx.static
        y0, rows = layout.rows(opts)
        grads = bricks._backward(bricked, opts, cam_off, g[y0:y0 + rows], fwd, fast=False)
        # the same keys on every rank: the collectives stay matched
        wanted = [key for key, need in zip(keys, ctx.needs_input_grad[5:]) if need]
        values = [grads[key][0] if key in GRID_KEYS else grads[key] for key in wanted]
        layout.sum_bands(values)
        got = {key: bricked.relay.whole(value) if key in GRID_KEYS else value
               for key, value in zip(wanted, values)}
        return (None,) * 5 + tuple(got[key].to(dev) if key in got else None
                                   for key, dev in zip(keys, devices))


def render_fused_bricked_ranks(scene: Scene, opts: RenderOptions,
                               camera_x_offset: float = 0.0, *,
                               mesh: Optional[RankMesh] = None) -> torch.Tensor:
    """``bricks.render_fused_bricked`` across the ranks, in plain PyTorch: a
    ``torch.autograd.Function`` whose forward is the bricked march of this
    rank's brick over its band and whose backward is that brick's replay,
    with the relay over the band's ranks. ``scene`` is the whole scene, the
    same on every rank; the image (H, W, 3) is the same on every rank, and
    so must be the loss of it. Gradients reach every leaf of
    ``split_scene(scene)`` that requires grad, whole and the same on every
    rank: summed over the bands (every band's, unlike the JAX package's
    rows x bricks backward, whose grids are one band's), a grid's parts
    then gathered over the band, so the ranks' optimizers keep the leaves
    equal. Any loss; unlit and lit scenes, lookup gradient volumes too."""
    diff, template = split_scene(scene)
    keys = tuple(diff)
    return _RenderFusedRanks.apply(template, opts, float(camera_x_offset), _layout(mesh), keys,
                                   *(diff[k] for k in keys))


# ---------------------------------------------------------------------------
# the local multi-process rehearsal
# ---------------------------------------------------------------------------

# the rehearsal's scene and steps: the JAX package's (multihost.py:_demo_worker)
DEMO = dict(volume=12, width=16, height=16, lr=1e-2)


def demo_problem(device: DeviceLike):
    """(scene, options, target, starting params) of the rehearsal: the lit
    flagship scene at 12^3, a 16 x 16 image of it as the target, and its
    params with the emission scaled by 1.2 and raised by 0.05."""
    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
    from volume_renderer_tpu_torch.utils.flagship import flagship_scene

    scene = flagship_scene(DEMO["volume"], lighting=True, device=device)
    opts = scene.options(DEMO["width"], DEMO["height"])
    target = render_forward_fast(scene, opts)
    params, static = train.split_params(scene)
    with torch.no_grad():
        params["emission"].mul_(1.2).add_(0.05)
    return static, opts, target, params


class BrickDemo(NamedTuple):
    """The bricked rehearsal's problem: the flagship shell at ``volume``^3,
    its volumes times seeded noise ``1 + noise (u - 1/2)`` (``noise`` 0: the
    smooth shell), seen through a ``width`` x ``height`` image by the
    flagship's camera turned by ``rotate``, in three cases: unlit, lit with
    on-the-fly gradients, and lit with lookup gradient volumes. ``fused``:
    each rank also takes a step of ``render_fused_bricked_ranks``, plain
    PyTorch (too slow for the card at full size)."""

    volume: int = DEMO["volume"]
    width: int = DEMO["width"]
    height: int = DEMO["height"]
    rotate: Tuple[float, float, float] = (125.0, 25.0, 0.0)
    noise: float = 0.0
    fused: bool = True


# this slice's full width: the bricked rehearsal of chip_smoke.py's four-rank
# world and of the CLI's --full
FULL = BrickDemo(volume=256, width=512, height=512, noise=0.05, fused=False)

BRICK_CASES = ("unlit", "lit", "lookup")


def brick_demo_cases(device: DeviceLike, spec: BrickDemo = BrickDemo(),
                     part: Optional[Tuple[int, int]] = None) -> Dict[str, tuple]:
    """Case name -> (scene, options, target, starting params) of the bricked
    rehearsal (``BrickDemo``): the target is the scene's single-device
    render, the params are ``train.split_params``' with the emission scaled
    by 1.2 and raised by 0.05.

    ``part`` (r, W): only the z-rows of brick r of W reach ``device``. The
    grids are made whole on the host (where their floats are the card's:
    numpy, and elementwise float32 products and differences) and cut there;
    the scene's and the params' grids are the rank's rows, the rest of the
    scene is on ``device``, and there is no target (None): a rank gets it
    as data."""
    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.models.camera import Camera
    from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
    from volume_renderer_tpu_torch.utils.flagship import flagship_scene

    dev = resolve_device(device)
    grid_dev = torch.device("cpu") if part else dev
    camera = Camera.create(focal_length=3.0, distance_to_object=6.0,
                           device=dev).rotate(*spec.rotate)
    factor = None
    if spec.noise:
        rng = np.random.default_rng(spec.volume)
        u = rng.random((spec.volume,) * 3, dtype=np.float32)
        factor = torch.from_numpy(1.0 + np.float32(spec.noise) * (u - np.float32(0.5))
                                  ).to(grid_dev)
    cases = {}
    for name in BRICK_CASES:
        scene = flagship_scene(spec.volume, lighting=name != "unlit", device=dev,
                               volume_device=grid_dev)
        scene = scene.replace(camera=camera)
        if factor is not None:
            scene = scene.replace(**{key: getattr(scene, key).replace(
                data=getattr(scene, key).data * factor)
                for key in ("emission", "absorption", "reflection")})
        if name == "lookup":
            scene = scene.replace(**dict(zip(("gradient_x", "gradient_y", "gradient_z"),
                                             scene.emission.gradient_volumes())))
        opts = scene.options(spec.width, spec.height)
        if part:
            rank, world = part
            scene = scene.replace(**{key: getattr(scene, key).replace(
                data=getattr(scene, key).data.chunk(world, dim=0)[rank].to(dev))
                for key in GRID_KEYS if getattr(scene, key) is not None})
        params, _ = train.split_params(scene)
        with torch.no_grad():
            params["emission"].mul_(1.2).add_(0.05)
        cases[name] = (scene, opts, None if part else render_forward_fast(scene, opts), params)
    return cases


def _demo_worker(rank: int, world: int, store: str, out_dir: str, device: Optional[str],
                 backend: Optional[str], spec: Optional[BrickDemo], bands: int) -> None:
    """One rank of the rehearsal: joins the group and runs the rays-DP
    rehearsal (``_dp_demo``) or, with ``spec``, the bricked one
    (``_brick_demo`` on ``bands`` x world / ``bands`` ranks, its targets
    from ``out_dir/targets.pt``); saves what it got to
    ``out_dir/rank<r>.pt`` (its traceback to ``rank<r>.err`` if it
    fails)."""
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            device = f"cuda:{rank % torch.cuda.device_count()}"
        dev = initialize(store, world, rank, device=device, backend=backend)
        out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
               "mesh": [str(d) for d in global_mesh(dev)]}
        out.update(_dp_demo(dev) if spec is None else _brick_demo(
            dev, spec, torch.load(os.path.join(out_dir, "targets.pt")), bands))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _dp_demo(dev: torch.device) -> dict:
    """Renders the flagship scene rays-DP, takes one Adam step of
    ``train_step_dp`` and, from the same start, one of
    ``train_step_fast_dp``."""
    from volume_renderer_tpu_torch.ops import cuda_march

    scene, opts, target, start = demo_problem(dev)
    cuda_march.reset_launch_counts()
    out = {"image": render_forward_dp(scene, opts).cpu()}
    for name, step in (("plain", train_step_dp), ("fast", train_step_fast_dp)):
        params = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
        optimizer = torch.optim.Adam(list(params.values()), lr=DEMO["lr"])
        loss = step(params, optimizer, scene, opts, target)
        out[name] = {"loss": float(loss),
                     "grads": {k: p.grad.cpu() for k, p in params.items()},
                     "params": {k: p.detach().cpu() for k, p in params.items()}}
    out["launches"] = dict(cuda_march.LAUNCHES_BY_MODE)
    return out


REPS = 5  # the warm calls a rehearsal's time is the median of


def wall_ms(call, devices: List[torch.device], reps: int = REPS):
    """(the last ``call()``, the median ms of ``reps`` calls after a warm
    one): each call timed on the host's clock from idle cards ``devices``
    to the end of its work on all of them (synchronised before and after),
    so that a rank and one process are timed alike."""
    out = call()
    times = []
    for _ in range(reps):
        for dev in devices:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = call()
        for dev in devices:
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(times))


def one_process_ms(scene: Scene, opts: RenderOptions, target: torch.Tensor, start: Params,
                   mesh: List[torch.device]) -> Dict[str, float]:
    """What a rank's times are held against: one process driving the same
    bricks on ``mesh`` (a case of ``brick_demo_cases``; every band's bricks,
    over the whole image), timed as
    ``_brick_demo`` times a rank (``wall_ms``): ``forward_ms`` of
    ``bricks.render_forward_bricked_fast`` on bricks cut before the timer,
    and ``step_ms`` of ``bricks.train_step_fast_bricked`` from ``start``."""
    from volume_renderer_tpu_torch import train

    split = bricks.split_bricks(scene, mesh)
    out = {"forward_ms": wall_ms(lambda: bricks.render_forward_bricked_fast(split, opts),
                                 mesh)[1]}
    params, static = bricks.split_params_bricked(train.merge_params(start, scene), mesh)
    optimizer = torch.optim.Adam(bricks.param_leaves(params), lr=DEMO["lr"])
    out["step_ms"] = wall_ms(lambda: bricks.train_step_fast_bricked(
        params, optimizer, static, opts, target), mesh)[1]
    return out


def _grids(scene: Scene) -> Dict[str, torch.Tensor]:
    return {key: getattr(scene, key).data for key in GRID_KEYS
            if getattr(scene, key) is not None}


def _brick_demo(dev: torch.device, spec: BrickDemo, targets: Dict[str, torch.Tensor],
                bands: int) -> dict:
    """For each case of ``brick_demo_cases``, built with this rank's z-rows
    alone (``part=``; ``targets``, the cases' target images, come as data),
    on ``bands`` x W / ``bands`` ranks (``global_mesh_2d``; one band: no
    mesh, a brick a rank): the bricked render, this rank's brick's entry
    record for its band, and ``voxel_grads_bricked_ranks`` for the
    cotangent of the sum-of-squares loss (every kernel is then loaded);
    then, counted from 0, the bricked render and one Adam step of
    ``train_step_fast_bricked_ranks``; on a card their ms (``wall_ms``: the
    median of ``REPS`` warm calls on the brick, steps after the first) and,
    over the whole rehearsal, the peak MiB that PyTorch allocated on the
    card (``peak_mib``). With ``spec.fused``, from the same start one Adam
    step of ``render_fused_bricked_ranks`` through autograd, whose grid
    leaves are whole (the whole scene is built for it). The lookup scene
    takes the lookup gradient segment. Grids are kept as this rank's rows."""
    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.ops import cuda_march

    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    mesh = global_mesh_2d(bands, dist.get_world_size() // bands) if bands > 1 else None
    layout = _layout(mesh)
    out = {"band": layout.band, "brick": layout.brick, "bands": layout.n_bands}
    whole = brick_demo_cases(dev, spec) if spec.fused else {}
    for name, (scene, opts, _, start) in brick_demo_cases(
            dev, spec, part=(layout.brick, layout.n_bricks)).items():
        target = targets[name].to(dev)
        res = {"rows": {key: int(data.shape[0]) for key, data in _grids(scene).items()}}
        brick = split_brick_rank(scene, grids=_grids(scene), mesh=mesh)
        y0, rows = layout.rows(opts)
        _, entry = cuda_bricks.brick_transmittance(brick, opts, y_offset=y0, n_rows=rows)
        res["entry"] = {"step": entry.step.cpu(), "state": entry.state.cpu()}
        g = 2.0 * (render_forward_bricked_ranks(brick, opts, mesh=mesh) - target)
        _, grads = voxel_grads_bricked_ranks(brick, opts, g, mesh=mesh)
        res["grads"] = {"grads": {k: v.cpu() for k, v in grads.items()}}

        cuda_march.reset_launch_counts()
        res["image"] = render_forward_bricked_ranks(brick, opts, mesh=mesh).cpu()
        merged = train.merge_params(start, scene)
        params, step_brick = split_params_bricked_rank(merged, grids=_grids(merged), mesh=mesh)
        optimizer = torch.optim.Adam(list(params.values()), lr=DEMO["lr"])

        def step():
            return train_step_fast_bricked_ranks(params, optimizer, step_brick, opts, target,
                                                 mesh=mesh)

        loss = step()
        res["fast"] = {"loss": float(loss),
                       "grads": {k: p.grad.detach().cpu().clone() for k, p in params.items()},
                       "params": {k: p.detach().cpu().clone() for k, p in params.items()}}
        res["launches"] = {k: v for k, v in cuda_march.LAUNCHES_BY_MODE.items() if v}
        if card:
            res["forward_ms"] = wall_ms(lambda: render_forward_bricked_ranks(brick, opts,
                                                                             mesh=mesh),
                                        [dev])[1]
            res["step_ms"] = wall_ms(step, [dev])[1]

        if spec.fused:
            scene, _, _, start = whole[name]
            params = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
            optimizer = torch.optim.Adam(list(params.values()), lr=DEMO["lr"])
            img = render_fused_bricked_ranks(train.merge_params(params, scene), opts, mesh=mesh)
            loss = torch.sum((img - target) ** 2)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()

            def own(key, t):  # this rank's z-rows of a whole grid
                part = t.chunk(layout.n_bricks, dim=0)[layout.brick] if key in GRID_KEYS else t
                return part.detach().cpu()

            res["fused"] = {"loss": float(loss.detach()),
                            "grads": {k: own(k, p.grad) for k, p in params.items()},
                            "params": {k: own(k, p) for k, p in params.items()}}
        out[name] = res
    if card:
        out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    return out


def _replicated(result: dict, bricked: bool, grids: bool = False) -> Dict[str, object]:
    """What every rank of the rehearsal must hold the same: the images, the
    losses and every gradient and parameter but the bricks' grid parts; with
    ``grids``, those parts alone, which the ranks of one brick (one a band)
    must hold the same."""
    if not bricked:
        steps = {"": result}
    else:
        steps = {f"{case} ": result[case] for case in BRICK_CASES}
    out = {}
    for prefix, res in steps.items():
        if not grids:
            out[f"{prefix}image"] = res["image"]
        for name in ("plain", "fast", "fused", "grads"):
            if name not in res:
                continue
            if "loss" in res[name] and not grids:
                out[f"{prefix}{name} loss"] = res[name]["loss"]
            for part in ("grads", "params"):
                for key, value in res[name].get(part, {}).items():
                    if (bricked and key in GRID_KEYS) == grids:
                        out[f"{prefix}{name} {part} {key}"] = value
    return out


def _differ(results: List[dict], bricked: bool, grids: bool = False) -> List[str]:
    """What ``results`` (some ranks') do not hold the same (``_replicated``)."""
    shared = [_replicated(r, bricked, grids) for r in results]
    return [what for what, value in shared[0].items()
            if not all(np.array_equal(np.asarray(other[what]), np.asarray(value))
                       for other in shared[1:])]


def run_demo(num_processes: int = 2, device: Optional[str] = None,
             backend: Optional[str] = None, timeout: float = 300.0,
             bricks: Optional[BrickDemo] = None, bands: int = 1) -> List[dict]:
    """Runs the rehearsal in ``num_processes`` spawned processes, one rank
    each, on ``device`` (None or "cuda": rank r on card r modulo the cards,
    as ``initialize`` picks; "cpu" asks for the CPU), and waits at most
    ``timeout`` seconds for them: a rank still running then is terminated
    and the call raises ``TimeoutError``; a rank that fails fails the call.
    Without ``bricks`` it is the rays-DP rehearsal (``_dp_demo``); with a
    ``BrickDemo`` the bricked one, a brick a rank (``_brick_demo``), whose
    target images this process renders first (``brick_demo_cases`` on
    ``device``, the first card for the cards), so that no rank holds a
    whole grid; ``bands`` > 1 lays the ranks out as ``bands`` x
    ``num_processes / bands`` (``global_mesh_2d``: rank (r, b) marches
    brick b over band r), and raises ``ValueError`` before it spawns a rank
    unless ``bands`` divides the processes and the image height. Checks
    that every rank holds the same images, losses, and gradients and params
    of what is replicated, and that the ranks of one brick hold the same
    grid parts, bit for bit, and returns each rank's results in rank order
    (the bricked rehearsal's grid parts are the rank's brick's:
    ``parallel.bricks.assemble`` joins one band's)."""
    if bands > 1:
        if bricks is None or num_processes % bands:
            raise ValueError(f"{bands} bands need the bricked rehearsal on a multiple of "
                             f"{bands} processes, not {num_processes}")
        if bricks.height % bands:
            raise ValueError(f"image height {bricks.height} must be divisible by the ray axis "
                             f"size {bands}")
    with tempfile.TemporaryDirectory(prefix="vr_multihost_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        if bricks is not None:
            host = "cpu" if device == "cpu" else None
            torch.save({name: case[2].cpu()
                        for name, case in brick_demo_cases(host, bricks).items()},
                       os.path.join(tmp, "targets.pt"))
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_demo_worker,
                             args=(r, num_processes, store, tmp, device, backend, bricks, bands))
                 for r in range(num_processes)]
        for p in procs:
            p.start()
        end = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10.0)
        if late:
            raise TimeoutError(f"ranks {late} of the rehearsal did not end within {timeout} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            errors = "\n".join(Path(tmp, f"rank{r}.err").read_text()
                               for r in failed if Path(tmp, f"rank{r}.err").exists())
            raise RuntimeError(f"ranks {sorted(failed)} of the rehearsal failed "
                               f"(exit codes {failed}):\n{errors}")
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(num_processes)]
    differ = _differ(results, bricks is not None)
    if differ:
        raise AssertionError(f"the ranks of the rehearsal differ in {differ}")
    n_bricks = num_processes // bands
    for b in range(n_bricks if bands > 1 else 0):
        differ = _differ(results[b::n_bricks], True, grids=True)
        if differ:
            raise AssertionError(f"the ranks of brick {b} differ in {differ}")
    return results


def _bricked_times(results: List[dict], spec: BrickDemo) -> dict:
    """The bricked rehearsal's times on the cards: each rank's forward and
    step ms and peak MiB, beside ``one_process_ms`` of one process driving
    the same bricks on the cards of the first band's ranks."""
    n_bricks = len(results) // results[0]["bands"]
    mesh = [torch.device(name) for name in results[0]["mesh"][:n_bricks]]
    rec = {"ranks": len(results), "bands": results[0]["bands"], "bricks": n_bricks,
           "backend": results[0]["backend"], "mesh": results[0]["mesh"],
           "config": f"{spec.volume}^3/{spec.width}x{spec.height}, noise {spec.noise}",
           "rank_peak_mib": [r["peak_mib"] for r in results]}
    for case, (scene, opts, target, start) in brick_demo_cases(mesh[0], spec).items():
        cell = {"rank_forward_ms": [r[case]["forward_ms"] for r in results],
                "rank_step_ms": [r[case]["step_ms"] for r in results]}
        cell["one_process"] = one_process_ms(scene, opts, target, start, mesh)
        rec[case] = cell
    return rec


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demo", action="store_true",
                    help="run the local multi-process rehearsal")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help='"cpu" for a CPU rehearsal (default: the cards)')
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    ap.add_argument("--bricks", action="store_true",
                    help="rehearse the z-brick relay (a brick a rank) instead of rays-DP")
    ap.add_argument("--full", action="store_true",
                    help="with --bricks: at this slice's full width (FULL, 256^3 / 512^2)")
    ap.add_argument("--bands", type=int, default=1,
                    help="with --bricks: the bands of image rows of a rows x bricks mesh "
                         "(rank (r, b) marches brick b of num-processes / bands over band r)")
    args = ap.parse_args()
    if args.demo and args.bricks:
        spec = FULL if args.full else BrickDemo()
        res = run_demo(args.num_processes, args.device, args.backend, timeout=600.0,
                       bricks=spec, bands=args.bands)
        losses = ", ".join(f"{case} {res[0][case]['fast']['loss']:.6f}"
                           for case in BRICK_CASES)
        print(f"multihost bricked demo ({args.num_processes} processes, {args.bands} x "
              f"{args.num_processes // args.bands} ranks, {res[0]['backend']} on "
              f"{res[0]['mesh']}): kernel-step losses {losses}; every rank equal")
        if args.device != "cpu":
            print(json.dumps(_bricked_times(res, spec)), flush=True)
    elif args.demo:
        res = run_demo(args.num_processes, args.device, args.backend)
        print(f"multihost demo ({args.num_processes} processes, {res[0]['backend']} on "
              f"{res[0]['mesh']}): plain loss {res[0]['plain']['loss']:.6f}, "
              f"kernel-step loss {res[0]['fast']['loss']:.6f}, every rank equal")
    else:
        print(_ENV_DOC)
