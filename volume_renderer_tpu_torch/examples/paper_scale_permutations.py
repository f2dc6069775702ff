"""Transfer-factor sweep -> montage grids.

Port of the JAX package's ``examples/paper_scale_permutations.py``
(reference examples/paper_scale_permutations.m): sweep the
reflection/absorption/emission factors over [0, 1] in ``--step`` x0.1
increments (6x6x6 renders at the default step 2), timing every render
with the Stopwatch, then write one montage image per reflection level
with absorption varying along y and emission along x
(paper_scale_permutations.m:76-129). This is the reference's de-facto
throughput benchmark; the facade's renders are K4 on the card.

Run: python -m volume_renderer_tpu_torch.examples.paper_scale_permutations [--size N]
     [--step S] [--device cpu]
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
from volume_renderer_tpu_torch.utils import Stopwatch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64, help="synthetic volume size")
    ap.add_argument("--res", type=int, nargs=2, default=None, help="image W H")
    ap.add_argument("--step", type=int, default=2,
                    help="sweep step in 0.1 factor units (reference stepsize=2)")
    ap.add_argument("--out", default="out/paper_scale")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)

    sw = Stopwatch("Movie generation")
    sw.add("rt", "render time")

    data_main, _, element_size_um = load_channels(args.size)
    render = VolumeRenderer(device=args.device)
    dev = render.device
    emission_main = Volume.create(data_main, device=dev)

    # general settings (paper_scale_permutations.m:31-60)
    render.volume_illumination = henyey_greenstein_lut(64, device=dev)
    render.light_sources = [LightSource([0, 5, 0], [0.5, 0.5, 0.5])]
    render.element_size_um = element_size_um
    render.focal_length = 3.0
    render.distance_to_object = 6
    render.rotate(45, 25, 45)
    render.opacity_threshold = 0.9
    if args.res:
        render.image_resolution = tuple(args.res)
    else:
        d, h, w = emission_main.data.shape
        render.image_resolution = (w, h)

    render.volume_emission = emission_main
    render.volume_absorption = Volume.create(np.ones((1, 1, 1), np.float32), device=dev)
    render.color = (1, 1, 1)

    levels = list(range(0, 11, args.step))
    w_img, h_img = render.image_resolution
    n = len(levels)

    os.makedirs(args.out, exist_ok=True)
    for r in levels:
        montage = np.zeros((n * h_img, n * w_img, 3), np.float32)
        for ai, a in enumerate(levels):
            for ei, e in enumerate(levels):
                render.factor_reflection = r * 0.1
                render.factor_absorption = a * 0.1
                render.factor_emission = e * 0.1
                sw.start("rt")
                img = render.render()
                sw.stop("rt", sync=img)
                montage[ai * h_img:(ai + 1) * h_img,
                        ei * w_img:(ei + 1) * w_img] = img.cpu().numpy()
        save_image(os.path.join(args.out, f"reflection_{r:02d}.png"), montage)
        print(f"wrote {args.out}/reflection_{r:02d}.png")

    sw.print()


if __name__ == "__main__":
    main()
