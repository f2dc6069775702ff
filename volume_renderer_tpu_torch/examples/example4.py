"""MRI-style render (BraTS variant).

Port of the JAX package's ``examples/example4.py`` (reference
examples/example4.m): a T1 MRI volume with a segmentation "structure"
channel, a masked fade, one dim light, and the example4 camera path. Loads
real nifti files when present (needs nibabel); otherwise uses a synthetic
head-like phantom. The facade's renders are K4 on the card.

Run: python -m volume_renderer_tpu_torch.examples.example4 [--size N] [--device cpu]
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
from volume_renderer_tpu_torch.examples._data import save_image

NIFTI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nifti-data")


def load_mri(n=96):
    t1_path = os.path.join(NIFTI_DIR, "BraTS20_Training_001_t1.nii")
    seg_path = os.path.join(NIFTI_DIR, "BraTS20_Training_001_seg.nii")
    if os.path.exists(t1_path):
        try:
            import nibabel as nib

            t1 = np.asarray(nib.load(t1_path).dataobj, np.float32)
            seg = np.asarray(nib.load(seg_path).dataobj, np.float32)
            return t1 / max(t1.max(), 1e-6), (seg > 0).astype(np.float32)
        except Exception as e:  # pragma: no cover
            print(f"nifti load failed ({e}); using phantom")
    # synthetic head phantom: skull shell + brain + a small bright 'tumor'
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2
    r = np.sqrt(((x - c) / (0.45 * n)) ** 2 + ((y - c) / (0.4 * n)) ** 2 + ((z - c) / (0.42 * n)) ** 2)
    skull = np.exp(-((r - 0.95) ** 2) / 0.002)
    brain = 0.6 * np.exp(-2.0 * r ** 2) * (r < 0.85)
    t1 = np.clip(skull + brain, 0, 1).astype(np.float32)
    tc = c + 0.15 * n
    tumor = (np.sqrt((x - tc) ** 2 + (y - c) ** 2 + (z - tc) ** 2) < 0.08 * n).astype(np.float32)
    return t1, tumor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--res", type=int, nargs=2, default=(160, 160))
    ap.add_argument("--out", default="out/example4")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)

    t1, seg = load_mri(args.size)
    render = VolumeRenderer(device=args.device)
    dev = render.device
    emission_main = Volume.create(t1, device=dev)
    emission_structure = Volume.create(seg, device=dev)

    render.color = (1, 1, 1)
    render.focal_length = 4.5
    render.distance_to_object = 4
    render.opacity_threshold = 0.95
    render.rotate(-90, 270, 0)
    render.rotate(-15, 15, 15)
    render.light_sources = [LightSource([-15, 15, 0], [0.5, 0.5, 0.5])]
    render.volume_illumination = henyey_greenstein_lut(64, device=dev)
    render.image_resolution = tuple(args.res)

    # main channel (emission == absorption, aliased)
    render.volume_emission = emission_main
    render.volume_absorption = emission_main
    img_main = render.render().cpu().numpy()

    # structure channel (tumor segmentation), red
    render.volume_emission = emission_structure
    render.volume_absorption = emission_structure
    render.color = (1, 0.2, 0.2)
    render.factor_emission = 3.0
    img_seg = render.render().cpu().numpy()

    combined = img_main + img_seg
    save_image(args.out + "_t1.png", img_main / max(img_main.max(), 1e-6))
    save_image(args.out + "_combined.png", combined / max(combined.max(), 1e-6))
    print(f"wrote {args.out}_combined.png")


if __name__ == "__main__":
    main()
