"""Inverse rendering of a LIT scene through the kernel backward.

Port of the JAX package's ``examples/example_inverse_lit.py`` (no reference
counterpart; the reference is forward-only): the reference's flagship
configuration (example1: HG-LUT shading with on-the-fly gradients, reference
examples/example1.m, volumeRender_kernel.cu:308-353) is rendered to a target
view, then a perturbed emission grid and the transfer/light parameters are
optimized to match with ``train.train_step_fast``: the lit forward kernel
(K4) and the lit scatter kernel (K6), which carries the shading chain's
cotangents (d shade -> d normal -> d taps).

Run: python -m volume_renderer_tpu_torch.examples.example_inverse_lit [--size 32]
     [--steps 20] [--device cpu]
"""

import argparse
import os

import torch

from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch._device import resolve_device
from volume_renderer_tpu_torch.examples._data import load_channels, save_image
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.scene import RenderSettings, Scene
from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.ops.hg import henyey_greenstein_lut


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="out/example_inverse_lit")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data, _, element_size_um = load_channels(args.size)
    cam = Camera.create(focal_length=3.0, distance_to_object=6.0, device=dev)
    cam = cam.rotate(125, 25, 0)
    vol = Volume.create(data, element_size_um=element_size_um, device=dev)
    scene = Scene(
        emission=vol,
        absorption=Volume.create(data * 0.8, device=dev),
        reflection=Volume.create(data, device=dev),
        camera=cam,
        settings=RenderSettings.create(
            factor_emission=1.0, factor_absorption=0.8,
            factor_reflection=0.5, color=(1.0, 0.9, 0.8), device=dev),
        illumination=henyey_greenstein_lut(32, device=dev),
        light_positions=torch.tensor([[2.0, 3.0, -1.5]], dtype=torch.float32, device=dev),
        light_colors=torch.tensor([[1.0, 1.0, 1.0]], dtype=torch.float32, device=dev),
    )
    opts = scene.options(args.res, args.res)
    target = render_forward_fast(scene, opts)
    os.makedirs(args.out, exist_ok=True)
    save_image(os.path.join(args.out, "target.png"), target.cpu().numpy())

    params, static_scene = train.split_params(scene)
    with torch.no_grad():
        params["emission"].mul_(1.5).add_(0.08)
        params["factor_reflection"].fill_(0.2)
    opt = torch.optim.Adam(list(params.values()), lr=3e-3)

    for i in range(args.steps):
        loss = train.train_step_fast(params, opt, static_scene, opts, target)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}: loss={float(loss):.6f}", flush=True)

    with torch.no_grad():
        final = render_forward_fast(train.merge_params(params, static_scene), opts)
        err = float(torch.mean((final - target) ** 2))
    save_image(os.path.join(args.out, "recovered.png"), final.cpu().numpy())
    print(f"final image MSE: {err:.3e} -> {args.out}/", flush=True)


if __name__ == "__main__":
    main()
