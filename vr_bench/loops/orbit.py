"""One client in a closed loop; a frame is one facade ``render()`` and the
image's copy to the host, then the camera turns by ``rotate_deg``. The
seed picks where on the orbit of ``frames_per_revolution`` frames the
window starts, and the frames and pixels the check compares
(``check.frames``, ``check.pixels_per_frame``)."""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import torch

from vr_bench import checks, program, roofline
from vr_bench.cell import Context, Window, op_shapes, ref_scene, rng, sync
from vr_bench.reference import lit_march as ref
from vr_bench.trace import span


def _phase(ctx: Context) -> int:
    return int(rng(ctx.seed, 1).integers(ctx.traffic["frames_per_revolution"]))


def _rotations(ctx: Context, frame: int) -> List:
    rot = ctx.traffic["rotate_deg"]
    return [ctx.cfg["pose"]] + [rot] * (_phase(ctx) + frame)


def setup(ctx: Context) -> None:
    r = program.renderer(ctx.cfg, ctx.inputs, ctx.width, ctx.height, ctx.device)
    for _ in range(_phase(ctx)):
        r.rotate(*ctx.traffic["rotate_deg"])
    r.render().cpu()          # loads the kernels; the window's one shape
    sync(ctx.device)
    program.reset_launches()
    ctx.state["renderer"] = r


def window(ctx: Context, seconds: float) -> Window:
    r = ctx.state["renderer"]
    rot = ctx.traffic["rotate_deg"]
    w = Window(seconds=0.0)
    images, plans = [], set()
    start = time.perf_counter()
    with span("window"):
        while True:
            t0 = time.perf_counter()
            with span("render"):
                img = r.render()
            t1 = time.perf_counter()
            with span("readback"):
                host = img.cpu()
            t2 = time.perf_counter()
            images.append(host)
            plans.add(r.last_plan.path if r.last_plan is not None else None)
            w.frame_s.append(t2 - t0)
            w.host_s.append(t1 - t0)
            with span("rotate"):
                r.rotate(*rot)
            if t2 - start >= seconds:
                break
    w.seconds = t2 - start
    w.frames = len(images)
    slow = sorted(range(len(w.frame_s)), key=lambda i: -w.frame_s[i])[:8]
    print("vr_bench: slowest frames (index, frame ms, render call ms): " + ", ".join(
        f"({i}, {1e3 * w.frame_s[i]:.1f}, {1e3 * w.host_s[i]:.1f})" for i in slow),
        file=sys.stderr)
    w.rays = w.frames * ctx.width * ctx.height
    ctx.state.update(images=images, plans=plans, launches=program.launches())
    return w


def route(ctx: Context, w: Window) -> List[str]:
    """What is wrong with the route the window's frames took; empty if each
    planned the cuda tier and launched one forward kernel."""
    mode = "K5" if ctx.inputs.gradients is not None else "K4"
    got = {k: v for k, v in ctx.state["launches"].items() if v}
    faults = []
    if ctx.state["plans"] != {"cuda"}:
        faults.append(f"plans {sorted(map(str, ctx.state['plans']))}, expected cuda")
    if got != {mode: w.frames}:
        faults.append(f"launches {got}, expected {{{mode!r}: {w.frames}}}")
    return faults


def release(ctx: Context) -> None:
    ctx.state.pop("renderer", None)


def check(ctx: Context, w: Window, dtype=torch.float64) -> Dict[str, float]:
    """The sampled frames' pixels against the reference's; with a ``dtype``
    below float64 the control's in the program's place (the program's
    images are then not read)."""
    chk = ctx.traffic["check"]
    images = ctx.state.get("images")
    pick_rng = rng(ctx.seed, 2)
    n = w.frames
    frames = sorted(set(pick_rng.choice(n, size=min(chk["frames"] - 1, n),
                                        replace=False).tolist()) | {n - 1})
    prog, refs = [], []
    for f in frames:
        scene64 = ref_scene(ctx, _rotations(ctx, f), torch.float64)
        c = ref.consts(tuple(scene64.emission.shape), scene64.element_size_um)
        allpix = torch.arange(ctx.width * ctx.height, device=ctx.device)
        hit = torch.nonzero(ref.rays(scene64, c, allpix, torch.float64).n_geo > 0).flatten()
        pick = hit[torch.as_tensor(pick_rng.choice(hit.numel(),
                                                   size=min(chk["pixels_per_frame"], hit.numel()),
                                                   replace=False), device=ctx.device)]
        truth = ref.render_pixels(scene64, pick)
        del scene64
        if dtype == torch.float64:
            got = images[f].reshape(-1, 3)[pick.cpu()]
        else:
            got = ref.render_pixels(ref_scene(ctx, _rotations(ctx, f), dtype), pick, dtype=dtype)
        prog.append(got.cpu())
        refs.append(truth.cpu())
    return {"pixel_gap": checks.pixel_gap(prog, refs)}


def poses(ctx: Context, w: Window) -> Dict[int, int]:
    """Orbit position -> frames of the window there."""
    out: Dict[int, int] = {}
    per = ctx.traffic["frames_per_revolution"]
    for f in range(w.frames):
        out[f % per] = out.get(f % per, 0) + 1
    return out


def least(ctx: Context, w: Window) -> Dict:
    """The forward kernel's least seconds over the window's frames, and the
    operations of the window's frames."""
    inp = ctx.inputs
    per_sample = roofline.fwd_flops_per_sample(lit=True, **op_shapes(ctx))
    nbytes = roofline.volume_bytes([inp.emission, inp.absorption, inp.reflection,
                                    inp.illumination, *(inp.gradients or ())])
    nbytes += ctx.width * ctx.height * 3 * 4
    seconds, bounds, flops = 0.0, set(), 0.0
    for pos, count in poses(ctx, w).items():
        samples = roofline.count_samples(ref_scene(ctx, _rotations(ctx, pos), torch.float64))
        lo = roofline.least_seconds(per_sample * samples, nbytes)
        seconds += count * lo["seconds"]
        bounds.add(lo["bound"])
        flops += count * per_sample * samples
    return {"fwd": {"seconds": seconds, "bound": "/".join(sorted(bounds))}, "flops": flops}


def readings(ctx: Context, faults, frames: int) -> Dict:
    """The control's number on ``frames`` frames' poses: the reference in
    bfloat16 in the program's place."""
    out = {}
    if "control" in faults:
        out["control"] = check(ctx, Window(seconds=0.0, frames=frames), dtype=torch.bfloat16)
    return out
