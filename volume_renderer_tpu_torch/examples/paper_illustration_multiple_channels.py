"""Two channels, two light sources, one illustration image.

Port of the JAX package's ``examples/paper_illustration_multiple_channels.py``
(reference examples/paper_illustration_multiple_channels.m): render the
structure channel (magenta, self-absorbing) and the main channel
(transparent white against a resized/normalized absorption volume) as
separate passes, print mem_info between them, and combine as
imcomplement(main) + structure (paper_illustration_multiple_channels.m:
49-80). The facade's renders are K4 on the card.

Run: python -m volume_renderer_tpu_torch.examples.paper_illustration_multiple_channels
     [--size N] [--device cpu]
"""

import argparse
import os

from volume_renderer_tpu_torch import (
    LightSource,
    Volume,
    VolumeRenderer,
    henyey_greenstein_lut,
)
from volume_renderer_tpu_torch.examples._data import load_channels, save_image


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96, help="synthetic volume size")
    ap.add_argument("--res", type=int, nargs=2, default=None, help="image W H")
    ap.add_argument("--out", default="out/paper_illustration")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)

    data_main, data_structure, element_size_um = load_channels(args.size)
    render = VolumeRenderer(device=args.device)
    dev = render.device
    emission_main = Volume.create(data_main, device=dev)
    emission_structure = Volume.create(data_structure, device=dev)

    # general settings (paper_illustration_multiple_channels.m:29-47)
    render.volume_illumination = henyey_greenstein_lut(64, device=dev)
    render.light_sources = [
        LightSource([0, 0, 3], [1, 1, 1]),
        LightSource([0, -5, 0], [1, 1, 1]),
    ]
    render.element_size_um = element_size_um
    render.focal_length = 4.5
    render.distance_to_object = 6
    render.rotate(45, 25, 45)
    render.opacity_threshold = 0.9
    if args.res:
        render.image_resolution = tuple(args.res)
    else:
        d, h, w = emission_structure.data.shape
        render.image_resolution = (w, h)

    # first image: structure channel (m:49-60)
    render.volume_emission = emission_structure
    render.volume_absorption = emission_structure
    render.factor_absorption = 0.6
    render.factor_reflection = 0.4
    render.color = (1, 0, 1)
    image_structure = render.render().cpu().numpy()

    print(render.mem_info())

    # second image: main channel against resized absorption (m:62-75)
    absorption = Volume.create(data_main, device=dev).resize(0.5).normalize(0, 1)
    render.volume_emission = emission_main
    render.volume_absorption = absorption
    render.factor_emission = 0.1
    render.factor_absorption = 0.4
    render.factor_reflection = 0.1
    render.color = (1, 1, 1)
    image_main = render.render().cpu().numpy()

    # imcomplement(main) + structure (m:78-80)
    main_n = VolumeRenderer.normalize_image(image_main)
    combined = (1.0 - main_n.numpy()) + image_structure

    os.makedirs(args.out, exist_ok=True)
    save_image(os.path.join(args.out, "structure.png"), image_structure)
    save_image(os.path.join(args.out, "main.png"), image_main)
    save_image(os.path.join(args.out, "combined.png"), combined)
    print(f"wrote {args.out}/structure.png, main.png, combined.png")


if __name__ == "__main__":
    main()
