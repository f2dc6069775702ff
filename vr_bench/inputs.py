"""The benchmark's inputs, made on the device from a configuration and a
seed, in plain PyTorch: the emission volume from the data generator the
configuration names (``data/<generator>.py``), the volumes derived from
it by the kinds it names (``volumes/<kind>.py``), the lights, a fit's
start. Both the program and the reference are handed these same tensors;
neither makes its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from vr_bench import named


@dataclass
class Inputs:
    """The volumes and tables of one configuration, float32 on the device."""

    emission: torch.Tensor
    absorption: torch.Tensor
    reflection: torch.Tensor
    gradients: Optional[tuple]     # (gx, gy, gz) or None
    illumination: torch.Tensor
    light_positions: torch.Tensor
    light_colors: torch.Tensor


def derived(spec: Optional[Dict], emission: torch.Tensor, device):
    """The volume of kind ``spec["kind"]``, or None for no entry."""
    if spec is None:
        return None
    return named.module("volumes", spec["kind"]).make(spec, emission, device)


def make_inputs(cfg: Dict, device, n: Optional[int] = None) -> Inputs:
    """``cfg``'s inputs; ``n`` overrides the data's size (the CPU tests)."""
    em = named.module("data", cfg["data"]["generator"]).make(cfg["data"], device, n)
    lights = cfg["lights"]
    return Inputs(
        emission=em, absorption=derived(cfg["absorption"], em, device),
        reflection=derived(cfg["reflection"], em, device),
        gradients=derived(cfg["gradient_volumes"], em, device),
        illumination=derived(cfg["illumination"], em, device),
        light_positions=torch.tensor([l["position"] for l in lights], dtype=torch.float32,
                                     device=device),
        light_colors=torch.tensor([l["color"] for l in lights], dtype=torch.float32,
                                  device=device))


def image_size(cfg: Dict, emission: torch.Tensor):
    """(W, H): the volume's (w, h), as example1 sets it, or the config's."""
    if cfg["image"] == "volume":
        d, h, w = emission.shape
        return int(w), int(h)
    return tuple(int(v) for v in cfg["image"])


def fit_starts(inp: Inputs, start: Dict[str, Dict], seed: int) -> Dict[str, torch.Tensor]:
    """A fit's start: each leaf that ``start`` names, in its order, is the
    true volume times ``1 + noise (u - 1/2)``, then ``* scale + shift``,
    with u uniform, drawn on the device by one generator seeded with
    ``seed``."""
    out = {}
    gen = None
    for leaf, spec in start.items():
        true = getattr(inp, leaf)
        if gen is None:
            gen = torch.Generator(device=true.device)
            gen.manual_seed(int(seed) % 2 ** 64)
        u = torch.rand(true.shape, generator=gen, device=true.device)
        out[leaf] = ((true * (1.0 + spec["noise"] * (u - 0.5))) * spec["scale"]
                     + spec["shift"]).contiguous()
    return out
