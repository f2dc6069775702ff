"""Camera-orbit video of one channel with a single light source.

Port of the JAX package's ``examples/example2.py`` (reference
examples/example2.m): 30 frames over a 360-degree orbit, each a facade
render (K4 on the card). Frames are written as PNGs; an .npz stack is saved
too.

Run: python -m volume_renderer_tpu_torch.examples.example2 [--frames N] [--device cpu]
"""

import argparse
import os

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
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--res", type=int, nargs=2, default=(128, 128))
    ap.add_argument("--out", default="out/example2")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)

    data_main, _, element_size_um = load_channels(args.size)
    render = VolumeRenderer(device=args.device)
    dev = render.device
    emission_main = Volume.create(data_main, device=dev)

    render.element_size_um = element_size_um
    render.volume_illumination = henyey_greenstein_lut(64, device=dev)
    render.light_sources = [LightSource([1500, 1500, 0], [1, 1, 1])]
    render.focal_length = 3.0
    render.distance_to_object = 6.0
    render.rotate(90, 0, 0)
    render.rotate(-15, -15, 15)

    render.volume_emission = emission_main
    render.volume_absorption = emission_main  # aliased: no extra gathers
    render.factor_reflection = 0.3
    render.factor_emission = 10
    render.color = (1, 1, 1)
    render.image_resolution = tuple(args.res)

    beta = 360.0 / args.frames
    frames = []
    for i in range(args.frames):
        img = render.render().cpu().numpy()
        frames.append(img)
        save_image(f"{args.out}_f{i:03d}.png", img / max(img.max(), 1e-6))
        render.rotate(0, beta, 0)
        print(f"frame {i + 1}/{args.frames}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out + "_frames.npz", frames=np.stack(frames))
    print(f"wrote {args.frames} frames to {args.out}_f*.png")


if __name__ == "__main__":
    main()
