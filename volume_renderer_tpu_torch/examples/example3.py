"""Two-channel movie with mask-driven fading and optional stereo.

Port of the JAX package's ``examples/example3.py`` (reference
examples/example3.m): the main channel orbits while a masked half of the
volume fades out and back; the structure channel is rendered as a second
pass over the same frames and the two image stacks are combined by
addition, then normalized (VolumeRender.normalizeSequence) and
sqrt-amplified like the reference's final movie step. The facade's
renders are K4 on the card (one light, the default reflection volume).

Run: python -m volume_renderer_tpu_torch.examples.example3 [--frames N] [--stereo]
     [--device cpu]
"""

import argparse
import os

import numpy as np
import torch

from volume_renderer_tpu_torch import (
    LightSource,
    StereoRenderMode,
    Volume,
    VolumeRenderer,
    henyey_greenstein_lut,
)
from volume_renderer_tpu_torch.examples._data import load_channels, save_image
from volume_renderer_tpu_torch.utils import Stopwatch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--res", type=int, nargs=2, default=(96, 96))
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--out", default="out/example3")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)

    data_main, data_structure, element_size_um = load_channels(args.size)

    # fade mask: ones except the top half of y, with a margin (example3.m
    # builds it from a resized/padded/thresholded copy of the volume)
    mask = np.zeros_like(data_main, dtype=bool)
    mask[:, data_main.shape[1] // 2:, :] = data_main[:, data_main.shape[1] // 2:, :] > 0.1

    sw = Stopwatch("timings")
    render = VolumeRenderer(device=args.device)
    dev = render.device
    render.element_size_um = element_size_um
    render.volume_illumination = henyey_greenstein_lut(64, device=dev)
    render.light_sources = [LightSource([1500, 1500, 0], [1, 1, 1])]
    render.focal_length = 3.0
    render.distance_to_object = 6.0
    render.rotate(90, 0, 0)
    render.rotate(-15, 15, 15)
    render.image_resolution = tuple(args.res)
    if args.stereo:
        render.stereo_output = StereoRenderMode.RED_CYAN
        render.camera_x_offset = 0.06

    total = args.frames
    beta = 1200.0 / 240.0  # reference rotation per frame

    # ---- main channel with fade (example3.m:115-180) ----
    render.volume_emission = Volume.create(data_main, device=dev)
    render.volume_absorption = render.volume_emission
    render.color = (1, 1, 1)

    fade_start, fade_end = total // 8, total - total // 8
    fade = np.linspace(1.0, 0.2, max(fade_end - fade_start, 1), dtype=np.float32)

    sw.add("m", "main channel")
    frames_main = []
    for i in range(total):
        if fade_start <= i < fade_end:
            data = data_main.copy()
            data[mask] = fade[i - fade_start] * data_main[mask]
            render.volume_emission = Volume.create(data, device=dev)
            render.volume_absorption = render.volume_emission
        sw.start("m")
        img = render.render()
        sw.stop("m", sync=img)
        frames_main.append(img.cpu().numpy())
        render.rotate(0, beta, 0)

    # ---- structure channel (example3.m:185-230) ----
    render.rotation_matrix = torch.eye(3, dtype=torch.float32, device=dev)
    render.rotate(90, 0, 0)
    render.rotate(-15, 15, 15)
    render.volume_emission = Volume.create(data_structure, device=dev)
    render.volume_absorption = render.volume_emission
    render.color = (0, 1, 0)
    render.factor_emission = 0.5

    sw.add("s", "structure channel")
    frames_structure = []
    for i in range(total):
        sw.start("s")
        img = render.render()
        sw.stop("s", sync=img)
        frames_structure.append(img.cpu().numpy())
        render.rotate(0, beta, 0)

    sw.print()

    combined = np.stack(frames_main) + np.stack(frames_structure)  # (T, H, W, 3)
    seq = np.moveaxis(combined, 0, -1)  # (H, W, 3, T) as normalizeSequence expects
    normalized = np.sqrt(VolumeRenderer.normalize_sequence(seq).numpy())

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out + "_movie.npz", frames=normalized)
    for i in range(0, total, max(total // 4, 1)):
        save_image(f"{args.out}_f{i:03d}.png", normalized[..., i])
    print(f"wrote {total} combined frames to {args.out}_movie.npz")


if __name__ == "__main__":
    main()
