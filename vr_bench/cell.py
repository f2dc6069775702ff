"""What every loop shares: the cell's context, the window's record, and
the reference's scene of the configuration made from the benchmark's own
inputs."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from vr_bench import inputs as inputs_mod
from vr_bench.reference import lit_march as ref


@dataclass
class Context:
    workload: str
    cfg: Dict
    traffic: Dict
    seed: int
    device: torch.device
    inputs: inputs_mod.Inputs
    width: int
    height: int
    state: Dict = field(default_factory=dict)


@dataclass
class Window:
    seconds: float
    frames: int = 0
    steps: int = 0
    frame_s: List[float] = field(default_factory=list)
    host_s: List[float] = field(default_factory=list)
    rays: int = 0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rng(seed: int, salt: int) -> np.random.Generator:
    seed = int(seed) % 2 ** 64
    return np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, salt])


def ref_inputs(ctx: Context, dtype) -> Dict[str, Optional[torch.Tensor]]:
    """The benchmark's inputs in ``dtype`` for the reference, made once a
    run (the lookup gradient volumes as one (D, H, W, 3) tensor)."""
    cache = ctx.state.setdefault("ref_inputs", {})
    if dtype not in cache:
        inp = ctx.inputs
        vols = {k: getattr(inp, k).to(dtype) for k in (
            "emission", "absorption", "reflection", "illumination", "light_positions",
            "light_colors")}
        vols["gradients"] = (None if inp.gradients is None else
                             torch.stack([g.to(dtype) for g in inp.gradients], dim=-1))
        cache[dtype] = vols
    return cache[dtype]


def ref_scene(ctx: Context, rotations, dtype, emission=None, absorption=None,
              factors=None) -> ref.RefScene:
    """The reference's scene of the configuration from the benchmark's own
    inputs (never the program's tensors), in ``dtype``."""
    cfg = ctx.cfg
    f = factors or {}

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=ctx.device)

    vols = ref_inputs(ctx, dtype)
    return ref.RefScene(
        emission=vols["emission"] if emission is None else emission,
        absorption=vols["absorption"] if absorption is None else absorption,
        reflection=vols["reflection"], gradients=vols["gradients"],
        illumination=vols["illumination"], light_positions=vols["light_positions"],
        light_colors=vols["light_colors"],
        factor_emission=f.get("factor_emission", t(cfg["factor_emission"])),
        factor_absorption=f.get("factor_absorption", t(cfg["factor_absorption"])),
        factor_reflection=f.get("factor_reflection", t(cfg["factor_reflection"])),
        color=f.get("color", t(cfg["color"])),
        opacity_threshold=float(cfg["opacity_threshold"]),
        element_size_um=tuple(cfg["element_size_um"]),
        rotation=torch.tensor(ref.pose(rotations), dtype=torch.float64),
        focal_length=float(cfg["focal_length"]),
        distance_to_object=float(cfg["distance_to_object"]),
        width=ctx.width, height=ctx.height)


def op_shapes(ctx: Context) -> Dict:
    """What the operation counts take of the scene: lookup or not, which
    volumes share emission's shape, the lights."""
    inp = ctx.inputs
    lookup = inp.gradients is not None
    same = tuple(inp.emission.shape)
    return dict(lookup=lookup, ab_same=tuple(inp.absorption.shape) == same,
                re_same=tuple(inp.reflection.shape) == same,
                grads_same=lookup and all(tuple(g.shape) == same for g in inp.gradients),
                n_lights=len(ctx.cfg["lights"]))
