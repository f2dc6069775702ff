#!/usr/bin/env python3
"""Drives the PyTorch port (volume_renderer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Phases, one JSON line each; any failure raises and exits nonzero:

1. device:  the card, its power limit, and the build of every kernel
            source (one nvcc each, started together).
2. goldens: the five tests/goldens scenes through VolumeRenderer on the
            card, held against the committed images.
3. kernel_vs_plain: the march kernel against its plain PyTorch version
            (ops/forward.py) on the card at 128^3 / 256x192, per mode.
4. main_path: VolumeRenderer.render() at 256^3 / 512^2 for the unlit (K1),
            lit on-the-fly (K4) and lit lookup (K5) flagship scenes, with
            the launch counts set to 0 just before and read just after;
            each image is held against the plain version on the whole image.
5. timing:  the kernel (CUDA events, warm, median of 7) and the plain
            version at 256^3 / 512^2 (K1, K4, K5) and 512^3 / 1024^2 (K1,
            K4; the plain version on a 64-row band through the middle),
            with rays/s, the march samples the rays took and the bound.

Then the kernels line and, last, {"ok": true, "device": {...}}. It needs
the repository around it and a CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"
# volume edge and image size of the phases
COMPARE = dict(volume=128, width=256, height=192)
MAIN = dict(volume=256, image=512)
BIG = dict(volume=512, image=1024, band=64)

# Published peaks of one H100 SXM at its full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float32 operations of one march step of csrc/march_fwd.cu, counted from
# its source (a transcendental counts as one): a trilinear fetch is 39
# (3 x (mul, sub, floor, sub, 2 clamps) + 7 lerps x 3), to_sample 6.
_FETCH, _COORDS = 39, 6
_STEP_UNLIT = _COORDS + _FETCH + 2 + 4 + 6 + 10 + 1 + 2 + 3  # + composite, t, stop, pos
_STEP_OTF_TAPS = 6 * (1 + _COORDS + _FETCH) + 6
_STEP_LOOKUP_TAPS = 3 * _FETCH
_STEP_NORMAL = 11 + 1  # + factor_reflection * re
_STEP_PER_LIGHT = 3 + 3 + 3 * 23 + 22 + _FETCH + 1 + 9


def flops_per_step(mode: str, ab_aliased: bool, re_aliased: bool, n_lights: int) -> int:
    ops = _STEP_UNLIT + (0 if ab_aliased else _FETCH)
    if mode != "K1":
        ops += (0 if re_aliased else _FETCH) + _STEP_NORMAL + 3 + n_lights * _STEP_PER_LIGHT
        ops += _STEP_LOOKUP_TAPS if mode == "K5" else _STEP_OTF_TAPS
    return ops


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every JSON line to this file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, REPO)

    from volume_renderer_tpu_torch import (
        Camera, LightSource, RenderSettings, Scene, StereoRenderMode, Volume, VolumeRenderer,
        henyey_greenstein_lut)
    from volume_renderer_tpu_torch.ops import _build, cuda_march
    from volume_renderer_tpu_torch.ops.cuda_march import kernel_mode, render_forward_fast
    from volume_renderer_tpu_torch.ops.forward import render_forward, render_rows

    lines = []

    def record(obj):
        lines.append(obj)
        emit(obj)

    dev = torch.device(DEVICE)
    kernel_path = "cuda" if dev.type == "cuda" else "plain"
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for name in _build.SOURCES for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    record({"phase": "device", "kind": kind, "nvidia_smi": smi_line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas})

    max_err = {"K1": 0.0, "K4": 0.0, "K5": 0.0}

    def check(name, got, want, atol, rtol, mode):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.isfinite(got).all(), f"{name}: non-finite values"
        err = float(np.abs(got - want).max())
        if mode is not None:
            max_err[mode] = max(max_err[mode], err)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)
        return err

    # ---- 2. goldens through the facade ----------------------------------
    # the scenes of tests/test_goldens.py, rebuilt with numpy
    def golden_vols(n=18):
        z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
        c = (n - 1) / 2.0
        r2 = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
        em = np.exp(-6.0 * (r2 - 0.55) ** 2).astype(np.float32)
        structure = (np.exp(-8.0 * ((x - c) / c) ** 2)
                     * np.exp(-4.0 * (r2 - 0.3) ** 2)).astype(np.float32)
        return em, structure

    def golden_base(em):
        r = VolumeRenderer()
        r.volume_emission = Volume.create(em)
        r.volume_absorption = Volume.create(em * 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (24, 20)
        return r

    def golden_render(name):
        em, structure = golden_vols()
        r = golden_base(em)
        if name in ("example1_otf", "example1_grad"):
            r.volume_reflection = Volume.create(em)
            r.volume_illumination = henyey_greenstein_lut(16)
            r.light_sources = [LightSource([5, 8, -4], [1.0, 0.7, 0.4])]
        if name == "example1_grad":
            r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                Volume.create(em).gradient_volumes())
            r.factor_emission, r.factor_absorption, r.factor_reflection = 1.2, 0.7, 0.5
        if name == "example3_two_channel":
            r.color = (1.0, 0.3, 1.0)
            r2 = golden_base(structure)
            r2.color = (0.3, 1.0, 0.3)
            return r.render() + r2.render()
        if name == "example2_stereo":
            r.camera_x_offset = 0.25
            r.stereo_output = StereoRenderMode.RED_CYAN
        img = r.render()
        assert r.last_plan.path == kernel_path
        return img

    golden_err = {}
    for name in ("pr1_plain", "example1_otf", "example1_grad", "example3_two_channel",
                 "example2_stereo"):
        golden = torch.from_numpy(np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npy")))
        # the goldens came from the JAX Pallas kernel (closed-form sample
        # positions); the port accumulates positions as the plain path does
        golden_err[name] = check(f"golden {name}", golden_render(name), golden, 1e-4, 1e-3, None)
    record({"phase": "goldens", "atol": 1e-4, "rtol": 1e-3, "max_abs_err": golden_err})

    # ---- scenes: the flagship gaussian shell (__graft_entry__.py) -------
    def shell(n):
        i = torch.arange(n, dtype=torch.float32, device=dev)
        c = (n - 1) / 2.0
        r2 = ((i[None, None, :] - c) ** 2 + (i[None, :, None] - c) ** 2
              + (i[:, None, None] - c) ** 2) / (c * c)
        return torch.exp(-4.0 * (torch.sqrt(r2) - 0.6) ** 2).contiguous()

    def flagship(n, mode, n_lights=1, ab_aliased=True, re_aliased=False):
        em = shell(n)
        ramp = torch.linspace(0.5, 1.0, n, device=dev)[None, None, :]
        ab = None if ab_aliased else Volume.create((em * ramp).contiguous())
        lit = {}
        if mode != "K1":
            lit = dict(illumination=henyey_greenstein_lut(32),
                       light_positions=torch.tensor([[2.0, 3.0, -1.5], [-1.0, 2.0, 2.0]],
                                                    device=dev)[:n_lights].contiguous(),
                       light_colors=torch.tensor([[1.0, 1.0, 1.0], [0.5, 0.6, 1.0]],
                                                 device=dev)[:n_lights].contiguous())
            if not re_aliased:
                lit["reflection"] = Volume.create(em.clone())
            if mode == "K5":
                lit.update(zip(("gradient_x", "gradient_y", "gradient_z"),
                               Volume.create(em).gradient_volumes()))
        return Scene(
            emission=Volume.create(em), absorption=ab,
            camera=Camera.create(focal_length=3.0, distance_to_object=6.0).rotate(125, 25, 0),
            settings=RenderSettings.create(factor_emission=1.0, factor_reflection=0.4,
                                           factor_absorption=0.6, color=(1.0, 0.9, 0.8),
                                           opacity_threshold=0.95),
            **lit)

    # tolerances: the kernel repeats the plain version's arithmetic in the
    # same order, without FMA contraction (-fmad=false); what may remain are
    # acosf/expf/rsqrtf ulps, carried when lit through the normal into the LUT
    tol = {"K1": (1e-5, 1e-4), "K4": (3e-5, 3e-4), "K5": (3e-5, 3e-4)}

    # ---- 3. kernel vs plain at 128^3 / 256x192 --------------------------
    compare = {}
    for name, mode, kw, offset in (
            ("K1_absorption_aliased", "K1", dict(ab_aliased=True), 0.0),
            ("K1_absorption_separate", "K1", dict(ab_aliased=False), 0.0),
            ("K4_two_lights", "K4", dict(n_lights=2, ab_aliased=False), 0.0),
            ("K5_lookup", "K5", dict(), 0.0),
            ("K4_stereo_offset_0.25", "K4", dict(re_aliased=True), 0.25)):
        scene = flagship(COMPARE["volume"], mode, **kw)
        assert kernel_mode(scene) == mode
        opts = scene.options(COMPARE["width"], COMPARE["height"])
        got = render_forward_fast(scene, opts, offset)
        torch.cuda.synchronize()
        compare[name] = check(f"kernel vs plain {name}", got, render_forward(scene, opts, offset),
                              *tol[mode], mode)
    record({"phase": "kernel_vs_plain", "volume": COMPARE["volume"],
            "image": [COMPARE["width"], COMPARE["height"]],
            "tolerance": {k: {"atol": a, "rtol": r} for k, (a, r) in tol.items()},
            "max_abs_err": compare})

    # ---- 4. the main path: VolumeRenderer.render() at 256^3 / 512^2 -----
    def facade(mode):
        em = shell(MAIN["volume"]).cpu().numpy()
        r = VolumeRenderer()
        r.volume_emission = Volume.create(em)
        r.volume_absorption = Volume.create(em)
        r.factor_absorption, r.factor_reflection, r.color = 0.6, 0.4, (1.0, 0.9, 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (MAIN["image"], MAIN["image"])
        if mode != "K1":
            r.volume_reflection = Volume.create(em)
            r.volume_illumination = henyey_greenstein_lut(32)
            r.light_sources = [LightSource([2.0, 3.0, -1.5], [1.0, 1.0, 1.0])]
        if mode == "K5":
            r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                Volume.create(em).gradient_volumes())
        return r

    renderers = {mode: facade(mode) for mode in ("K1", "K4", "K5")}
    for r in renderers.values():  # content hashes for the dedup, outside the window
        r._build_scene()
    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    images = {mode: r.render() for mode, r in renderers.items()}
    torch.cuda.synchronize()
    launches = dict(cuda_march.LAUNCHES_BY_MODE)
    main = {"launches": launches, "total_launches": cuda_march.LAUNCHES}
    for mode, img in images.items():
        if launches[mode] < 1:
            raise RuntimeError(f"the main path launched no {mode} kernel: {launches}")
        assert renderers[mode].last_plan.path == kernel_path
        scene = renderers[mode]._build_scene()
        opts = scene.options(MAIN["image"], MAIN["image"])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = render_forward(scene, opts)
        end.record()
        end.synchronize()
        main[mode] = {"max_abs_err": check(f"main path {mode}", img, plain, *tol[mode], mode),
                      "plain_ms": start.elapsed_time(end),
                      "nonzero_frac": float((img.amax(-1) > 0).float().mean()),
                      "finite": bool(torch.isfinite(img).all())}
    record({"phase": "main_path", "entry": "VolumeRenderer.render", "volume": MAIN["volume"],
            "image": MAIN["image"], **main})

    # ---- 5. timing at 256^3 / 512^2 and 512^3 / 1024^2 -------------------
    def volume_bytes(scene, mode):
        vols = [scene.emission.data]
        if not scene.absorption_aliased:
            vols.append(scene.absorption.data)
        if mode != "K1":
            vols.append(scene.illumination)
            if not scene.reflection_aliased:
                vols.append(scene.reflection.data)
            if mode == "K5":
                vols += [scene.gradient_x.data, scene.gradient_y.data, scene.gradient_z.data]
        return sum(v.numel() * 4 for v in vols)

    def time_cell(scene, size, band_rows=None, reps=7):
        mode = kernel_mode(scene)
        opts = scene.options(size, size)
        steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
        img = render_forward_fast(scene, opts, steps=steps)  # warm-up, and the step counts
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            render_forward_fast(scene, opts)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times))
        y0 = 0 if band_rows is None else (size - band_rows) // 2
        rows = size if band_rows is None else band_rows
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = render_rows(scene, opts, 0.0, y0, rows)
        end.record()
        end.synchronize()
        err = check(f"timing cell {mode} {size}", img[y0:y0 + rows], plain, *tol[mode], mode)
        samples = int(steps.sum())
        n_lights = 0 if mode == "K1" else scene.light_positions.shape[0]
        flops = samples * flops_per_step(mode, scene.absorption_aliased,
                                         scene.reflection_aliased, n_lights)
        nbytes = volume_bytes(scene, mode) + size * size * 3 * 4
        bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "operations": flops / PEAK_FP32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        return {"mode": mode, "image": size, "ms": ms, "ms_all": times,
                "rays_per_s": size * size / (ms * 1e-3), "samples": samples,
                "samples_per_ray": samples / (size * size), "flops": flops, "bytes": nbytes,
                "bound_ms": bound[bound_by], "bound_by": bound_by,
                "plain_ms": start.elapsed_time(end), "plain_rows": rows, "max_abs_err": err,
                "finite": bool(torch.isfinite(img).all()),
                "nonzero_frac": float((img.amax(-1) > 0).float().mean())}

    cells = {}
    for cfg, modes, band, reps in ((MAIN, ("K1", "K4", "K5"), None, 7),
                                   (BIG, ("K1", "K4"), BIG["band"], 5)):
        for mode in modes:
            key = f"{mode}_{cfg['volume']}_{cfg['image']}"
            scene = flagship(cfg["volume"], mode, ab_aliased=False)
            cells[key] = time_cell(scene, cfg["image"], band_rows=band, reps=reps)
            record({"phase": "timing", "cell": key, "volume": cfg["volume"], **cells[key]})
            del scene
            if DEVICE == "cuda":
                torch.cuda.empty_cache()

    # ---- kernels line and the result ------------------------------------
    kernels = []
    for mode, what in (("K1", "unlit"), ("K4", "lit, on-the-fly gradients"),
                       ("K5", "lit, lookup gradients")):
        cell = cells[f"{mode}_{MAIN['volume']}_{MAIN['image']}"]
        kernels.append({
            "name": f"march_fwd[{mode}]", "route": "cuda",
            "source": "volume_renderer_tpu_torch/csrc/march_fwd.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": launches[mode], "max_abs_err": max_err[mode],
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "bound_ms": cell["bound_ms"],
            "bound_by": cell["bound_by"], "library_ms": None,
            "mode": what, "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image",
            "ms_big": cells.get(f"{mode}_{BIG['volume']}_{BIG['image']}", {}).get("ms"),
        })
    for name, cell in cells.items():
        if not (cell["finite"] and cell["nonzero_frac"] > 0.05):
            raise RuntimeError(f"cell {name} rendered nothing useful: {cell}")
    record({"kernels": kernels})
    if args.out:
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
