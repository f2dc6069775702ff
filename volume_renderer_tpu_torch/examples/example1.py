"""Two channels + two light sources -> one static image.

Port of the JAX package's ``examples/example1.py`` (reference
examples/example1.m): render the structure channel and the main channel as
separate passes (the reference's multi-pass convention, SURVEY.md C21) and
combine the images by addition. The facade plans each render (the march
kernel on the card: K4, lit with on-the-fly gradients).

Run: python -m volume_renderer_tpu_torch.examples.example1 [--size N] [--res W H]
     [--device cpu]
"""

import argparse

from volume_renderer_tpu_torch import (
    LightSource,
    Volume,
    VolumeRenderer,
    henyey_greenstein_lut,
)
from volume_renderer_tpu_torch.examples._data import load_channels, save_image
from volume_renderer_tpu_torch.utils import Stopwatch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96, help="synthetic volume size")
    ap.add_argument("--res", type=int, nargs=2, default=None, help="image W H")
    ap.add_argument("--out", default="out/example1")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)

    sw = Stopwatch("timings")
    sw.add("r", "benchmark rendering")

    data_main, data_structure, element_size_um = load_channels(args.size)
    render = VolumeRenderer(device=args.device)
    dev = render.device
    emission_main = Volume.create(data_main, device=dev)
    emission_structure = Volume.create(data_structure, device=dev)

    # setup general render settings (example1.m:30-48)
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
    if args.res:
        render.image_resolution = tuple(args.res)
    else:
        d, h, w = emission_structure.data.shape
        render.image_resolution = (w, h)

    # first image (structure): emission == absorption -> aliased volume
    render.volume_emission = emission_structure
    render.volume_absorption = emission_structure
    render.factor_absorption = 0.6
    render.factor_reflection = 0.4
    render.color = (1, 1, 0)
    image_structure = render.render().cpu().numpy()

    print(render.mem_info())

    # second image (main): resized+normalized absorption (example1.m:64-75)
    absorption = Volume.create(data_main, device=dev).resize(0.5).normalize(0, 1)
    render.volume_emission = emission_main
    render.volume_absorption = absorption
    render.factor_emission = 0.1
    render.factor_absorption = 0.4
    render.factor_reflection = 0.1
    render.color = (1, 1, 1)

    sw.start("r")
    image = render.render()
    sw.stop("r", sync=image)
    image_main = image.cpu().numpy()

    sw.print()

    combined = image_main + image_structure
    save_image(args.out + "_structure.png", image_structure)
    save_image(args.out + "_main.png", image_main)
    save_image(args.out + "_combined.png", combined)
    print(f"wrote {args.out}_combined.png  (max={combined.max():.3f})")


if __name__ == "__main__":
    main()
