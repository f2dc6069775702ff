"""Rays-DP with the march kernels per band (port of
``volume_renderer_tpu.parallel.pallas_dp``).

Every band of image rows (``parallel.sharding.bands``) is one launch of the
forward kernel (K1, K4 or K5, ``ops.cuda_march.render_rows_fast``) and, with
gradients, one of the scatter kernel (K3, K6 or K6L, ``ops.cuda_grads``) on
the band's device, as the TPU kernel runs with ``band=`` in every shard:

- forward: no communication; the bands are joined on ``mesh[0]``;
- backward: the bands of one device scatter into one set of gradient grids
  (their atomic adds commute), so a device holds one set however many
  bands it marches (K6L's bands from K5's pack share its accumulators of
  the grids' cotangents too, unpacked into the set once after the last);
  the sets of the devices and the bands' parameter
  gradients are summed on ``mesh[0]``, the counterpart of ``psum``.

K5's packed grid is made once for each device and call (a render, a
backward, a training step) and read by every band there, K5's and K6L's
alike. Bands that share a CUDA device run on streams of their own,
joined before the sum, so that their launches fill the card together: a
band alone leaves it half idle, and one after another on one stream four
bands of 512^2 took 1.6-2.3 times the single launch on an H100, on their
own streams 0.87-0.97 times (PERF.md). On CPU devices every band runs the
kernels' plain versions.

No fallback: where the single-device kernels raise, these raise too. Lit
gradients carry every key that single-device ``voxel_grads_fast`` gives: the
reflection grid (and a lookup scene's three gradient grids),
``factor_reflection`` and ``light_colors`` are summed like the rest (the
JAX package zeroes ``factor_reflection`` and drops the lit extras,
``pallas_dp.py:241``, ``:128``).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops.cuda_grads import (
    unpack_accumulator, voxel_grads_fast, zero_accumulators, zero_grids)
from volume_renderer_tpu_torch.ops.cuda_march import lookup_pack, render_rows_fast
from volume_renderer_tpu_torch.parallel.mesh import check_mesh
from volume_renderer_tpu_torch.parallel.sharding import bands, scenes_on
from volume_renderer_tpu_torch.train import merge_params

Mesh = Sequence[torch.device]


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def _run_bands(mesh: List[torch.device], work: Callable[[int], object]) -> list:
    """``work(i)`` for every band i, on its device's current stream or,
    where the band shares a CUDA device with another, on a stream of its
    own that waits for the current one first; the current streams wait for
    every band before this returns."""
    shared = Counter(mesh)
    results, joins = [], []
    for i, dev in enumerate(mesh):
        if not (dev.type == "cuda" and shared[dev] > 1):
            results.append(work(i))
            continue
        # a stream of PyTorch's pool, handed out round-robin: the bands of
        # one call get streams of their own
        side, current = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = work(i)
        results.append(out)
        joins.append((side, current, out))
    for side, current, out in joins:
        current.wait_stream(side)
        for t in _tensors(out):  # made on the side stream, used on the current one
            t.record_stream(current)
    return results


def _layout(opts: RenderOptions, mesh: List[torch.device]
            ) -> List[Tuple[torch.device, int, int]]:
    """(device, first row, rows) of every band that has rows."""
    return [(dev, y0, rows) for dev, (y0, rows) in zip(mesh, bands(opts.height, len(mesh)))
            if rows]


def _forward(on: Dict[torch.device, Scene], opts: RenderOptions, camera_x_offset: float,
             mesh: List[torch.device], packs: Dict[torch.device, Optional[torch.Tensor]]
             ) -> torch.Tensor:
    """The bands' forward launches over the scenes ``on`` each device, with
    each device's K5 pack (``ops.cuda_march.lookup_pack``, None for another
    scene); (H, W, 3) on ``mesh[0]``."""
    layout = _layout(opts, mesh)

    def work(k):
        dev, y0, rows = layout[k]
        return render_rows_fast(on[dev], opts, camera_x_offset, y0, rows, packed=packs[dev])

    parts = _run_bands([band[0] for band in layout], work)
    return torch.cat([p.to(mesh[0]) for p in parts])


def _backward(on: Dict[torch.device, Scene], opts: RenderOptions, g, camera_x_offset: float,
              image: torch.Tensor, mesh: List[torch.device],
              packs: Dict[torch.device, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The bands' scatter launches for the cotangent ``g`` of ``image``,
    every gradient summed on ``mesh[0]``; ``on`` and ``packs`` as in
    ``_forward``."""
    dev0 = mesh[0]
    g = torch.as_tensor(g, dtype=torch.float32, device=dev0)
    shape = (opts.height, opts.width, 3)
    if tuple(g.shape) != shape or tuple(image.shape) != shape:
        raise ValueError(f"g and image must be {shape}, got {tuple(g.shape)} and "
                         f"{tuple(image.shape)}")
    grids = {dev: zero_grids(s) for dev, s in on.items()}
    # K6L from the pack: one set of accumulators a device, none for any other scene
    accs = {dev: zero_accumulators(s) if packs[dev] is not None else []
            for dev, s in on.items()}
    layout = _layout(opts, mesh)

    def work(k):
        dev, y0, rows = layout[k]
        cut = slice(y0, y0 + rows)
        grads = voxel_grads_fast(on[dev], opts, g[cut].to(dev), camera_x_offset,
                                 image[cut].to(dev).contiguous(), y_offset=y0, n_rows=rows,
                                 grids=grids[dev], packed=packs[dev],
                                 accumulators=accs[dev] or None)[1]
        # the grids stay in grids[dev]; the band's own keys were made on its stream
        return {key: value for key, value in grads.items() if key not in grids[dev]}

    per_band = _run_bands([band[0] for band in layout], work)
    for dev, dev_accs in accs.items():  # after every band of the device (_run_bands joins them)
        for acc in dev_accs:
            unpack_accumulator(acc, grids[dev])
    del accs
    parts = {key: [acc[key] for acc in grids.values()] for key in grids[layout[0][0]]}
    parts.update({key: [band[key] for band in per_band] for key in per_band[0]})
    out = {}
    for key, (first, *rest) in parts.items():
        # into the first part, which is this call's own: no grid-sized copy on one device
        out[key] = first.to(dev0)
        for part in rest:
            out[key].add_(part.to(dev0))
    return out


def _on(scene: Scene, mesh: Mesh):
    """The checked mesh, the scene on each of its devices, and each
    device's K5 pack: made once for a call's forward and backward."""
    mesh = check_mesh(mesh, "band")
    on = scenes_on(scene, mesh)
    return mesh, on, {dev: lookup_pack(s) for dev, s in on.items()}


def render_forward_fast_sharded(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0,
                                *, mesh: Mesh) -> torch.Tensor:
    """Rays-DP forward render: one launch of the forward kernel a band on
    its device (the plain version on CPU devices); (H, W, 3) on
    ``mesh[0]``, equal to ``render_forward_fast`` bit for bit."""
    mesh, on, packs = _on(scene, mesh)
    return _forward(on, opts, camera_x_offset, mesh, packs)


def voxel_grads_fast_sharded(scene: Scene, opts: RenderOptions, g, camera_x_offset: float = 0.0,
                             image: Optional[torch.Tensor] = None, *, mesh: Mesh
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Rays-DP backward: ``(image, grads)`` like ``voxel_grads_fast``, one
    launch of the scatter kernel a band (and one of the forward kernel a
    band unless ``image``, ``render_forward_fast_sharded``'s output, is
    given). Every gradient is summed over the bands, on ``mesh[0]``: the
    grids once per device (the bands of a device share them), the
    parameters' per band."""
    mesh, on, packs = _on(scene, mesh)
    if image is None:
        image = _forward(on, opts, camera_x_offset, mesh, packs)
    return image, _backward(on, opts, g, camera_x_offset, image, mesh, packs)


def train_step_fast_sharded(params: Dict[str, torch.Tensor], optimizer: torch.optim.Optimizer,
                            scene: Scene, opts: RenderOptions, target: torch.Tensor, *,
                            mesh: Mesh, camera_x_offset: float = 0.0) -> torch.Tensor:
    """Rays-DP training step at kernel speed, the counterpart of
    ``train.train_step_fast`` (sum-of-squares loss, ``params`` of
    ``train.split_params`` on ``mesh[0]``, any ``torch.optim.Optimizer``):
    the forward kernel a band, the closed-form cotangent ``2 (img -
    target)``, the scatter kernel a band, the gradients summed on
    ``mesh[0]``, one optimizer step. Updates ``params`` in place and returns
    the loss before the update."""
    with torch.no_grad():
        mesh, on, packs = _on(merge_params(params, scene), mesh)
        img = _forward(on, opts, camera_x_offset, mesh, packs)
        resid = img - target.to(img.device, torch.float32)
        loss = torch.sum(resid ** 2)
        grads = _backward(on, opts, 2.0 * resid, camera_x_offset, img, mesh, packs)
        for key, p in params.items():
            p.grad = grads[key].reshape(p.shape).to(p.device)
    optimizer.step()
    return loss
