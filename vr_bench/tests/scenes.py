"""Small scenes of the benchmark's configurations for the CPU tests."""

import json
import os

import torch

from vr_bench import inputs
from vr_bench.reference import lit_march as ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name: str):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def small_inputs(n: int, lookup: bool):
    cfg = config("vibez-lookup" if lookup else "vibez-otf")
    return cfg, inputs.make_inputs(cfg, "cpu", n=n)


def small_scene(n: int, lookup: bool, dtype, rotations=None) -> ref.RefScene:
    cfg, inp = small_inputs(n, lookup)
    w, h = inputs.image_size(cfg, inp.emission)
    grads = None if inp.gradients is None else torch.stack(inp.gradients, -1).to(dtype)
    t = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    return ref.RefScene(
        emission=inp.emission.to(dtype), absorption=inp.absorption.to(dtype),
        reflection=inp.reflection.to(dtype), gradients=grads,
        illumination=inp.illumination.to(dtype), light_positions=inp.light_positions.to(dtype),
        light_colors=inp.light_colors.to(dtype), factor_emission=t(cfg["factor_emission"]),
        factor_absorption=t(cfg["factor_absorption"]),
        factor_reflection=t(cfg["factor_reflection"]), color=t(cfg["color"]),
        opacity_threshold=cfg["opacity_threshold"], element_size_um=tuple(cfg["element_size_um"]),
        rotation=torch.tensor(ref.pose(rotations or [cfg["pose"]])),
        focal_length=cfg["focal_length"], distance_to_object=cfg["distance_to_object"],
        width=w, height=h)
