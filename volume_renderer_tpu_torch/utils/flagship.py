"""The flagship scene: a smooth gaussian shell, lit by one light (the port's
own copy of the JAX package's ``__graft_entry__._flagship_scene``, which its
scaling probe and multi-host rehearsal render). Built from its formula, so
every process that builds it gets the same floats."""

from __future__ import annotations

import numpy as np

from volume_renderer_tpu_torch._device import DeviceLike, as_float32, resolve_device
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.scene import RenderSettings, Scene
from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.ops.hg import henyey_greenstein_lut


def flagship_scene(vol: int = 48, lighting: bool = True, device: DeviceLike = None,
                   volume_device: DeviceLike = None) -> Scene:
    """The shell in a ``vol``^3 volume, emission, absorption and reflection
    each a volume of its own with the same values, under the camera
    ``rotate(125, 25, 0)``; with ``lighting`` the 32^3 Henyey-Greenstein LUT
    and one white light. On ``device`` (default: the card), the volumes on
    ``volume_device`` if one is named (the host, for a rank that moves only
    its rows to the card)."""
    dev = resolve_device(device)
    vdev = dev if volume_device is None else resolve_device(volume_device)
    z, y, x = np.mgrid[0:vol, 0:vol, 0:vol].astype(np.float32)
    c = (vol - 1) / 2.0
    r2 = ((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / (c * c)
    em = np.exp(-4.0 * (np.sqrt(r2) - 0.6) ** 2).astype(np.float32)
    lit = {}
    if lighting:
        lit = dict(illumination=henyey_greenstein_lut(32, device=dev),
                   light_positions=as_float32([[2.0, 3.0, -1.5]], dev),
                   light_colors=as_float32([[1.0, 1.0, 1.0]], dev))
    return Scene(
        emission=Volume.create(em, device=vdev), absorption=Volume.create(em, device=vdev),
        reflection=Volume.create(em, device=vdev),
        camera=Camera.create(focal_length=3.0, distance_to_object=6.0,
                             device=dev).rotate(125, 25, 0),
        settings=RenderSettings.create(factor_emission=1.0, factor_reflection=0.4,
                                       factor_absorption=0.6, color=(1.0, 0.9, 0.8),
                                       opacity_threshold=0.95, device=dev),
        **lit)
