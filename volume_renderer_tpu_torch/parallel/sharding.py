"""Rays-DP: the image cut into bands of rows over a device list (port of
``volume_renderer_tpu.parallel.sharding``).

The port is one process that drives every device. ``mesh`` is a list of n
``torch.device``s (``make_mesh``); band i, image rows [i * r, (i + 1) * r)
with r = ceil(H / n), is marched on ``mesh[i]`` against its own copy of the
scene (one copy for each distinct device, none where the scene lies
already), and the bands are joined on ``mesh[0]``. The forward needs no
communication; gradients are summed on ``mesh[0]``. The JAX package pads
the image to n * r rows and crops; here the last band has fewer rows (and
a band past the image none): the same image, without the padded rays.

``render_forward_sharded`` is the plain march per band;
``parallel.pallas_dp`` runs the kernels per band, and
``train.train_step_sharded`` differentiates the plain bands.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops.forward import render_rows
from volume_renderer_tpu_torch.parallel.mesh import check_mesh, make_mesh  # noqa: F401

RAY_AXIS = "rays"


def bands(height: int, n: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each of ``n`` bands of an image of ``height``
    rows: ceil(height / n) rows each, the last ones fewer or none."""
    rows = -(-int(height) // int(n))
    return [(min(i * rows, height), max(0, min(rows, height - i * rows))) for i in range(n)]


def scenes_on(scene: Scene, mesh: Sequence[torch.device]) -> Dict[torch.device, Scene]:
    """The scene on every distinct device of ``mesh``, copied once each."""
    return {dev: scene.to(dev) for dev in dict.fromkeys(mesh)}


def render_forward_sharded(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0, *,
                           mesh: Sequence[torch.device], differentiable: bool = False
                           ) -> torch.Tensor:
    """Forward render with the image rows cut into bands over ``mesh``, the
    plain march (``ops.forward.render_rows``) per band; (H, W, 3) on
    ``mesh[0]``. ``differentiable``: the fixed trip count, for
    ``torch.autograd`` (the copies between devices stay in the graph)."""
    mesh = check_mesh(mesh, "band")
    on = scenes_on(scene, mesh)
    parts = [render_rows(on[dev], opts, camera_x_offset, y0, rows,
                         differentiable=differentiable).to(mesh[0])
             for dev, (y0, rows) in zip(mesh, bands(opts.height, len(mesh))) if rows]
    return torch.cat(parts)
