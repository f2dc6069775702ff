"""Total work of the sharded paths, one shard against eight (port of
``volume_renderer_tpu.utils.scaling_probe``).

What it measures is total work, not scaling: both runs render the same
image from the same scene (asserted), and the eight-shard run also pays for
being cut:

    work_efficiency = work(1 shard) / work(8 shards)

the share of the sharded run's work that is render work. Reported
unclamped: above 1 the shards did less work than the whole (smaller working
sets, better caches).

- On the CPU (``device="cpu"``) work is process CPU seconds
  (``time.process_time``, every thread's) over the plain paths, as the JAX
  probe counts it: ``rays_dp`` is ``parallel.sharding.render_forward_sharded``
  over ``make_mesh(1 | 8, "cpu")``, ``bricked`` is
  ``parallel.bricks.render_forward_bricked``.
- On the card work is the device time of the whole call, CUDA events
  recorded just before and just after it, all shards on the one card:
  ``rays_dp`` is ``parallel.pallas_dp.render_forward_fast_sharded`` over
  ``make_mesh(1 | 8)`` (a launch of the forward kernel a band, the eight
  bands on streams of their own), ``bricked`` is
  ``parallel.bricks.render_forward_bricked_fast`` of the scene cut into one
  brick or eight (K7 phase 1 and phase 2 a brick, and the relay between
  them). What eight cards would add, the copies between them, is not in it.

Run as a module; it prints one JSON line::

    python -m volume_renderer_tpu_torch.utils.scaling_probe            # the card
    python -m volume_renderer_tpu_torch.utils.scaling_probe --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device

SHARDS = 8


def _cpu_work(render: Callable[[], torch.Tensor], reps: int):
    """(process seconds, wall seconds) a call, the mean of ``reps`` after a
    warm call, and the last output."""
    out = render()
    c0, w0 = time.process_time(), time.perf_counter()
    for _ in range(reps):
        out = render()
    return (time.process_time() - c0) / reps, (time.perf_counter() - w0) / reps, out


def _card_work(render: Callable[[], torch.Tensor], reps: int):
    """(device ms, wall ms) a call, the medians of ``reps`` after a warm
    call, and the last output; device ms are read from CUDA events recorded
    on the current stream just before and just after the call."""
    out = render()
    device, wall = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        start.record()
        out = render()
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - w0) * 1e3)
        device.append(start.elapsed_time(end))
    return float(np.median(device)), float(np.median(wall)), out


def _paths(scene, opts, card: bool):
    """The two sharded paths, as render(n_shards) -> image: the kernels'
    entry points on the card, the plain ones on the CPU."""
    from volume_renderer_tpu_torch.parallel import bricks
    from volume_renderer_tpu_torch.parallel.mesh import make_mesh
    from volume_renderer_tpu_torch.parallel.pallas_dp import render_forward_fast_sharded
    from volume_renderer_tpu_torch.parallel.sharding import render_forward_sharded

    if not card:
        return {"rays_dp": lambda n: render_forward_sharded(scene, opts, mesh=make_mesh(n, "cpu")),
                "bricked": lambda n: bricks.render_forward_bricked(
                    scene, opts, mesh=make_mesh(n, "cpu"))}
    # the bricks are cut once, outside the timed calls
    split = {n: bricks.split_bricks(scene, make_mesh(n, scene.device)) for n in (1, SHARDS)}
    return {"rays_dp": lambda n: render_forward_fast_sharded(
                scene, opts, mesh=make_mesh(n, scene.device)),
            "bricked": lambda n: bricks.render_forward_bricked_fast(split[n], opts)}


def measure(device: DeviceLike = None, vol: Optional[int] = None, img: Optional[int] = None,
            reps: int = 3) -> dict:
    """The probe's record: for ``rays_dp`` and ``bricked`` the work of one and
    of ``SHARDS`` shards and ``work_efficiency``; the headline
    ``work_efficiency`` is the bricked path's, which pays for the relay and
    the halos. ``vol`` and ``img`` default to 64^3 / 128^2 on the CPU (the
    JAX probe's) and 256^3 / 512^2 on the card."""
    from volume_renderer_tpu_torch.utils.flagship import flagship_scene

    dev = resolve_device(device)
    card = dev.type == "cuda"
    vol = vol or (256 if card else 64)
    img = img or (512 if card else 128)
    scene = flagship_scene(vol, lighting=False, device=dev)
    opts = scene.options(img, img)
    rec = {
        "probe": f"total-work overhead, 1 vs {SHARDS} shards, all on one "
                 + ("card" if card else "CPU process"),
        "definition": (f"work_efficiency = work(1 shard) / work({SHARDS} shards); work = "
                       + ("device ms of the whole call (CUDA events around it)" if card
                          else "process CPU seconds") + "; identical output asserted; unclamped"),
        "device": torch.cuda.get_device_name(dev) if card else "cpu",
        "config": f"{vol}^3/{img}^2, lighting off",
    }
    work_of = _card_work if card else _cpu_work
    for name, path in _paths(scene, opts, card).items():
        (k1, w1, out1), (k8, w8, out8) = (
            work_of(lambda n=n: path(n), reps) for n in (1, SHARDS))
        # the premise: the same render, or the comparison of work means nothing
        if name == "rays_dp" and not torch.equal(out1, out8):
            raise AssertionError("rays_dp: 1-shard and 8-shard images differ")
        if not np.allclose(out1.cpu().numpy(), out8.cpu().numpy(), atol=1e-5, rtol=1e-4):
            raise AssertionError(f"{name}: 1-shard and {SHARDS}-shard images differ")
        unit = "ms" if card else "s"
        work = "device" if card else "cpu"
        rec[name] = {f"{work}1_{unit}": k1, f"{work}{SHARDS}_{unit}": k8,
                     f"wall1_{unit}": w1, f"wall{SHARDS}_{unit}": w8,
                     "work_efficiency": k1 / k8, "overhead_fraction": (k8 - k1) / k8}
    rec["work_efficiency"] = rec["bricked"]["work_efficiency"]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
