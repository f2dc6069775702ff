"""Inverse rendering: recover a voxel grid from rendered views.

Port of the JAX package's ``examples/example_inverse.py`` (no reference
counterpart): render a target view of a known scene, then optimize a
perturbed emission grid (and the transfer factors) to match through the
replay backward (``train.train_step``: ``render_fused``, plain PyTorch). With
more than one card dividing the image height, the rays are cut into bands
over them (``train.train_step_sharded``). Like the JAX script, which runs
XLA and not its kernel, it launches no kernel.

Run: python -m volume_renderer_tpu_torch.examples.example_inverse [--steps N] [--device cpu]
"""

import argparse

import numpy as np
import torch

from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch._device import resolve_device
from volume_renderer_tpu_torch.examples._data import load_channels, save_image
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.scene import RenderSettings, Scene
from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.ops.forward import render_forward
from volume_renderer_tpu_torch.parallel.mesh import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--out", default="out/example_inverse")
    ap.add_argument("--device", default=None, help='"cpu" for the CPU (default: the card)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data_main, _, element_size_um = load_channels(args.size)
    target_scene = Scene(
        emission=Volume.create(data_main, element_size_um, device=dev),
        absorption=None,  # aliased to emission
        camera=Camera.create(focal_length=3.0, distance_to_object=6.0,
                             device=dev).rotate(125, 25, 0),
        settings=RenderSettings.create(factor_absorption=0.5, device=dev),
    )
    opts = target_scene.options(args.res, args.res)
    target = render_forward(target_scene, opts)

    params, static_scene = train.split_params(target_scene)
    rng = np.random.default_rng(0)
    start = np.clip(params["emission"].detach().cpu().numpy() * 0.5
                    + 0.3 * rng.random(params["emission"].shape, np.float32), 0, 1)
    with torch.no_grad():
        params["emission"].copy_(torch.from_numpy(start))

    optimizer = torch.optim.Adam(list(params.values()), lr=3e-3)

    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh = make_mesh(n_dev) if n_dev > 1 and args.res % n_dev == 0 else None
    print(f"devices: {n_dev}; sharded: {mesh is not None}")

    for i in range(args.steps):
        if mesh is not None:
            loss = train.train_step_sharded(params, optimizer, static_scene, opts, target,
                                            mesh=mesh)
        else:
            loss = train.train_step(params, optimizer, static_scene, opts, target)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {float(loss):.5f}")

    with torch.no_grad():
        final_scene = train.merge_params(params, static_scene)
        final = render_forward(final_scene, opts).cpu().numpy()
        em_err = float(torch.mean(torch.abs(params["emission"] - target_scene.emission.data)))
    save_image(args.out + "_target.png",
               target.cpu().numpy() / max(float(torch.max(target)), 1e-6))
    save_image(args.out + "_recovered.png", final / max(final.max(), 1e-6))
    print(f"mean |emission error|: {em_err:.4f}; wrote {args.out}_*.png")


if __name__ == "__main__":
    main()
