"""One client in a closed loop of ``train.train_step_fast`` with Adam
(``lr``) on ``split_params``' parameters, from a start made from the seed
(``start``: the leaves it perturbs, each by ``inputs.fit_starts``); step i
fits target view i mod ``views``, the camera turned ``view_rotate_deg``
from one view to the next (the seed picks the first). The first
``check.steps`` steps run in set-up, through the same call, and are what
the check compares; the loss is read on the host every ``loss_every``
steps."""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Dict, List

import torch

from vr_bench import checks, inputs, program, roofline
from vr_bench.cell import Context, Window, op_shapes, ref_scene, rng, sync
from vr_bench.reference import lit_march as ref
from vr_bench.trace import span

LEAVES = ("emission", "absorption", "factor_emission", "factor_absorption",
          "factor_reflection", "color")


def _first_view(ctx: Context) -> int:
    return int(rng(ctx.seed, 3).integers(ctx.traffic["views"]))


def _view(ctx: Context, step: int) -> int:
    return (_first_view(ctx) + step) % ctx.traffic["views"]


def _view_rotations(ctx: Context, view: int) -> List:
    return [ctx.cfg["pose"]] + [ctx.traffic["view_rotate_deg"]] * view


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().to(torch.float64)))
            for k, v in tensors.items()}


def setup(ctx: Context) -> None:
    cfg, tr = ctx.cfg, ctx.traffic
    true_scene = program.scene(cfg, ctx.inputs, [cfg["pose"]], ctx.device)
    views = [true_scene.replace(camera=program.camera(cfg, _view_rotations(ctx, v), ctx.device))
             for v in range(tr["views"])]
    opts = true_scene.options(ctx.width, ctx.height)
    targets = [program.render(s, ctx.width, ctx.height) for s in views]
    params, static = program.split_params(true_scene)
    starts = inputs.fit_starts(ctx.inputs, tr["start"], ctx.seed)
    with torch.no_grad():
        for leaf, value in starts.items():
            params[leaf].copy_(value)
    del starts
    opt = torch.optim.Adam(list(params.values()), lr=tr["lr"])
    ctx.state.update(params=params, views=[static.replace(camera=s.camera) for s in views],
                     opts=opts, targets=targets, opt=opt)
    first = {k: p.detach().clone() for k, p in params.items()}
    losses = []
    program.reset_launches()
    for i in range(tr["check"]["steps"]):
        losses.append(float(_step(ctx, i)))
        if i == 0:
            b1 = opt.param_groups[0]["betas"][0]
            grad = {k: opt.state[p]["exp_avg"] / (1 - b1) for k, p in params.items()}
            grad_norms = _norms(grad)
            del grad
    change = _norms({k: p.detach() - first[k] for k, p in params.items()})
    del first
    ctx.state["checked"] = {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
    ctx.state["setup_launches"] = program.launches()
    sync(ctx.device)
    program.reset_launches()


def _step(ctx: Context, i: int) -> torch.Tensor:
    st = ctx.state
    v = _view(ctx, i)
    return program.train_step(st["params"], st["opt"], st["views"][v], st["opts"],
                              st["targets"][v])


def window(ctx: Context, seconds: float) -> Window:
    every = ctx.traffic["loss_every"]
    i = ctx.traffic["check"]["steps"]
    w = Window(seconds=0.0)
    start = time.perf_counter()
    with span("window"):
        while True:
            with span("step"):
                loss = _step(ctx, i)
            i += 1
            w.steps += 1
            if i % every == 0:
                with span("loss_read"):
                    float(loss)
            if time.perf_counter() - start >= seconds:
                break
        with span("synchronize"):
            sync(ctx.device)
    w.seconds = time.perf_counter() - start
    ctx.state["launches"] = program.launches()
    return w


def route(ctx: Context, w: Window) -> List[str]:
    fwd, bwd = ("K5", "K6L") if ctx.inputs.gradients is not None else ("K4", "K6")
    faults = []
    for name, got, n in (("set-up", ctx.state["setup_launches"], ctx.traffic["check"]["steps"]),
                         ("window", ctx.state["launches"], w.steps)):
        modes = {k: v for k, v in got.items() if v and " " not in k}
        if modes != {fwd: n, bwd: n}:
            faults.append(f"{name} launches {modes}, expected {{{fwd!r}: {n}, {bwd!r}: {n}}}")
    return faults


def release(ctx: Context) -> None:
    for k in ("params", "views", "opts", "targets", "opt"):
        ctx.state.pop(k, None)


def reference(ctx: Context, dtype=torch.float64, keep_rows=None) -> Dict:
    """The reference's first steps from the same start: losses, the first
    gradient's norms and the change's norms by leaf."""
    tr, cfg = ctx.traffic, ctx.cfg

    def leaf(v):
        return v.detach().to(dtype).clone().requires_grad_(True)

    starts = inputs.fit_starts(ctx.inputs, tr["start"], ctx.seed)
    params = {k: leaf(starts.get(k, getattr(ctx.inputs, k))) for k in LEAVES[:2]}
    del starts
    for k in LEAVES[2:]:
        params[k] = leaf(torch.as_tensor(cfg[k], dtype=torch.float32, device=ctx.device))
    first = {k: v.detach().clone() for k, v in params.items()}
    opt = ref.Adam(params, lr=tr["lr"])
    losses = []
    grad_norms = None
    for i in range(tr["check"]["steps"]):
        t0 = time.perf_counter()
        rots = _view_rotations(ctx, _view(ctx, i))
        target = ref.render_image(ref_scene(ctx, rots, dtype), dtype=dtype)
        t1 = time.perf_counter()
        scene = ref_scene(ctx, rots, dtype, emission=params["emission"],
                          absorption=params["absorption"],
                          factors={k: params[k] for k in LEAVES[2:]})
        loss, _ = ref.loss_and_grads(scene, target, dtype=dtype, keep_rows=keep_rows)
        del scene, target
        losses.append(float(loss))
        print(f"vr_bench: reference step {i + 1} ({dtype}): target {t1 - t0:.3f} s, "
              f"loss and gradients {time.perf_counter() - t1:.3f} s", file=sys.stderr)
        if i == 0:
            grad_norms = _norms({k: v.grad for k, v in params.items()})
        opt.step()
    change = _norms({k: v.detach() - first[k] for k, v in params.items()})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def check(ctx: Context, w: Window) -> Dict[str, float]:
    truth = reference(ctx)
    for name, got in (("program", ctx.state["checked"]), ("reference", truth)):
        print(f"vr_bench: {name}: {json.dumps(got)}", file=sys.stderr)
    return checks.fit_numbers(ctx.state["checked"], truth, checks.grid_leaves(ctx.workload))


def least(ctx: Context, w: Window) -> Dict:
    """The forward and backward kernels' least seconds over the window's
    steps, and the operations of the window's steps."""
    inp = ctx.inputs
    kw = op_shapes(ctx)
    fwd_ops = roofline.fwd_flops_per_sample(lit=True, **kw)
    bwd_ops = roofline.bwd_flops_per_sample(**kw)
    vols = [inp.emission, inp.absorption, inp.reflection, *(inp.gradients or ())]
    image = ctx.width * ctx.height * 3 * 4
    fwd_bytes = roofline.volume_bytes(vols + [inp.illumination]) + image
    # the backward reads the volumes, the LUT, the image and its cotangent,
    # and writes a gradient of each volume it scatters into
    bwd_bytes = 2 * roofline.volume_bytes(vols) + roofline.volume_bytes([inp.illumination])
    bwd_bytes += 2 * image
    first = ctx.traffic["check"]["steps"]
    counts: Dict[int, int] = {}
    for i in range(first, first + w.steps):
        counts[_view(ctx, i)] = counts.get(_view(ctx, i), 0) + 1
    out = {"fwd": {"seconds": 0.0, "bound": set()}, "bwd": {"seconds": 0.0, "bound": set()},
           "flops": 0.0}
    for v, count in counts.items():
        samples = roofline.count_samples(ref_scene(ctx, _view_rotations(ctx, v), torch.float64))
        for key, ops, nbytes in (("fwd", fwd_ops, fwd_bytes), ("bwd", bwd_ops, bwd_bytes)):
            lo = roofline.least_seconds(ops * samples, nbytes)
            out[key]["seconds"] += count * lo["seconds"]
            out[key]["bound"].add(lo["bound"])
            out["flops"] += count * ops * samples
    for key in ("fwd", "bwd"):
        out[key]["bound"] = "/".join(sorted(out[key]["bound"]))
    return out


def readings(ctx: Context, faults, frames: int) -> Dict:
    """The program's check steps (``program``, set-up alone, no window), the
    control (``control``: the reference in bfloat16 in the program's
    place) and half of the batch left out (``half_batch``: the loss over
    the top half of the rays, doubled), each against the float64
    reference."""
    out = {}
    grid = checks.grid_leaves(ctx.workload)
    if "program" in faults:
        setup(ctx)
        release(ctx)
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    truth = reference(ctx)
    out["reference"] = truth
    if "program" in faults:
        got = ctx.state["checked"]
        out["program"] = {"numbers": checks.fit_numbers(got, truth, grid), "readings": got}
    width, height = ctx.width, ctx.height

    def top_half(pixels):
        return (pixels // width < height // 2).to(torch.float64) * 2.0

    for name, kw in (("control", {"dtype": torch.bfloat16}), ("half_batch",
                                                              {"keep_rows": top_half})):
        if name in faults:
            got = reference(ctx, **kw)
            out[name] = {"numbers": checks.fit_numbers(got, truth, grid), "readings": got}
    return out
