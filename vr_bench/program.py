"""The system under test, reached only through its public entry points:
the facade ``VolumeRenderer`` for renders, ``train.split_params`` and
``train.train_step_fast`` for fits, ``render_forward_fast`` for a fit's
targets, and the launch counters of ``ops.cuda_march``. The port is
imported here, inside functions, and nowhere else in the harness.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from vr_bench.inputs import Inputs

def port():
    import volume_renderer_tpu_torch as vr

    return vr


def launches() -> Dict[str, int]:
    """The port's kernel launches by mode and by form since its last reset."""
    from volume_renderer_tpu_torch.ops import cuda_march

    out = dict(cuda_march.LAUNCHES_BY_MODE)
    out.update(cuda_march.LAUNCHES_BY_FORM)
    return out


def reset_launches() -> None:
    from volume_renderer_tpu_torch.ops import cuda_march

    cuda_march.reset_launch_counts()


def renderer(cfg: Dict, inp: Inputs, width: int, height: int, device):
    """The facade set up as the configuration's example sets it, at its
    start pose."""
    vr = port()
    r = vr.VolumeRenderer(device=device)
    r.volume_emission = vr.Volume.create(inp.emission, device=device)
    r.volume_absorption = vr.Volume.create(inp.absorption, device=device)
    if inp.gradients is not None:
        r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
            vr.Volume.create(g, device=device) for g in inp.gradients)
    r.volume_illumination = inp.illumination
    r.light_sources = [vr.LightSource(l["position"], l["color"]) for l in cfg["lights"]]
    r.element_size_um = tuple(cfg["element_size_um"])
    r.focal_length = cfg["focal_length"]
    r.distance_to_object = cfg["distance_to_object"]
    r.rotate(*cfg["pose"])
    r.opacity_threshold = cfg["opacity_threshold"]
    r.factor_emission = cfg["factor_emission"]
    r.factor_absorption = cfg["factor_absorption"]
    r.factor_reflection = cfg["factor_reflection"]
    r.color = tuple(cfg["color"])
    r.image_resolution = (width, height)
    return r


def scene(cfg: Dict, inp: Inputs, rotations: Sequence[Sequence[float]], device):
    """The port's ``Scene`` of the configuration (what the facade builds:
    the default 1x1x1 reflection volume), its camera after ``rotations``."""
    vr = port()
    cam = camera(cfg, rotations, device)
    grads = {}
    if inp.gradients is not None:
        grads = dict(zip(("gradient_x", "gradient_y", "gradient_z"),
                         (vr.Volume.create(g, device=device) for g in inp.gradients)))
    return vr.Scene(
        emission=vr.Volume.create(inp.emission, tuple(cfg["element_size_um"]), device=device),
        absorption=vr.Volume.create(inp.absorption, device=device),
        reflection=vr.Volume.create(inp.reflection, device=device),
        camera=cam,
        settings=vr.RenderSettings.create(
            factor_emission=cfg["factor_emission"], factor_reflection=cfg["factor_reflection"],
            factor_absorption=cfg["factor_absorption"], color=tuple(cfg["color"]),
            opacity_threshold=cfg["opacity_threshold"], device=device),
        illumination=inp.illumination, light_positions=inp.light_positions,
        light_colors=inp.light_colors, **grads)


def camera(cfg: Dict, rotations: Sequence[Sequence[float]], device):
    """The configuration's camera after the ``rotate`` calls ``rotations``."""
    vr = port()
    cam = vr.Camera.create(focal_length=cfg["focal_length"],
                           distance_to_object=cfg["distance_to_object"], device=device)
    for rot in rotations:
        cam = cam.rotate(*rot)
    return cam


def render(scene_, width: int, height: int) -> torch.Tensor:
    vr = port()
    return vr.render_forward_fast(scene_, scene_.options(width, height))


def split_params(scene_):
    return port().train.split_params(scene_)


def train_step(params, optimizer, scene_, opts, target) -> torch.Tensor:
    return port().train.train_step_fast(params, optimizer, scene_, opts, target)
