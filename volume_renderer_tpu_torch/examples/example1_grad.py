"""Precomputed-gradient-volume variant of example1 + mode-switch check.

Port of the JAX package's ``examples/example1_grad.py`` (reference
examples/example1_grad.m): the surface-normal source is three precomputed
gradient volumes (MATLAB ``gradient`` axis convention, Volume.grad_matlab)
instead of on-the-fly central differences (K5 on the card); at the end the
gradients are reset and the scene re-rendered in compute mode (K4;
example1_grad.m:93-98).

Run: python -m volume_renderer_tpu_torch.examples.example1_grad [--size N] [--device cpu]
"""

import argparse

import numpy as np

from volume_renderer_tpu_torch import (
    LightSource,
    Volume,
    VolumeRenderer,
    henyey_greenstein_lut,
)
from volume_renderer_tpu_torch.examples._data import load_channels, save_image


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--out", default="out/example1_grad")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)

    data_main, data_structure, element_size_um = load_channels(args.size)
    render = VolumeRenderer(device=args.device)
    dev = render.device
    emission_main = Volume.create(data_main, device=dev)
    emission_structure = Volume.create(data_structure, device=dev)

    # gradients of the main channel, MATLAB axis pairing (example1_grad.m:28)
    g_x, g_y, g_z = emission_main.grad_matlab()

    render.volume_gradient_x = g_x
    render.volume_gradient_y = g_y
    render.volume_gradient_z = g_z
    render.volume_illumination = henyey_greenstein_lut(64, device=dev)
    render.light_sources = [
        LightSource([500, 1000, 550], [0, 1, 1]),
        LightSource([0, 550, 90], [1, 0.5, 1]),
    ]
    render.element_size_um = element_size_um
    render.focal_length = 3.0
    render.distance_to_object = 6
    render.rotate(125, 25, 0)
    render.opacity_threshold = 0.9
    d, h, w = emission_structure.data.shape
    render.image_resolution = (w, h)

    render.volume_emission = emission_main
    render.volume_absorption = Volume.create(data_main, device=dev).resize(0.5).normalize(0, 1)
    render.factor_emission = 0.1
    render.factor_absorption = 0.4
    render.factor_reflection = 0.1
    render.color = (1, 1, 1)

    image_lookup = render.render().cpu().numpy()
    save_image(args.out + "_lookup.png", image_lookup)

    # switch back to on-the-fly gradient computation and re-render
    render.reset_gradient_volumes()
    image_computed = render.render().cpu().numpy()
    save_image(args.out + "_computed.png", image_computed)

    corr = np.corrcoef(image_lookup.ravel(), image_computed.ravel())[0, 1]
    print(f"lookup-vs-computed correlation: {corr:.3f}")
    print(f"wrote {args.out}_lookup.png / _computed.png")


if __name__ == "__main__":
    main()
