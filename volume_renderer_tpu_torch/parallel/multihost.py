"""Several processes over ``torch.distributed`` (port of
``volume_renderer_tpu.parallel.multihost``).

The JAX package joins N processes into one device namespace with
``jax.distributed.initialize`` and runs its ``shard_map`` paths over a mesh
of every host's devices. The port's counterpart is a process group: every
process runs the same program on one device, a card or the CPU, and the
collectives are NCCL's between cards and gloo's on the CPU.

- ``initialize`` joins this process to the group
  (``torch.distributed.init_process_group``). With no arguments it takes its
  rank, world size and address from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), as JAX
  detects them on a pod; a cluster without a launcher passes them.
- ``global_mesh`` is the group's rank-to-device layout: the device of each
  rank, in rank order.
- Rays-DP across ranks: rank r marches band r of the image rows
  (``parallel.sharding.bands``: the bands that ``MarchArgs.row0`` and
  ``image_height`` march, a launch of the forward kernel a band).
  ``render_forward_dp`` joins the bands with ``all_gather``. The training
  steps, ``train_step_dp`` (autograd over the plain band loss, the
  counterpart of ``train.train_step_sharded``) and ``train_step_fast_dp``
  (the kernels: K1 + K3 unlit, K4 + K6 lit; ``train_step_fast_sharded``'s),
  ``all_reduce`` the loss and every gradient with SUM, and every rank then
  takes the same optimizer step on its own copy of the parameters, so the
  copies stay equal. A gloo group reduces a card's tensors through host
  copies.
- ``run_demo`` rehearses it: it spawns N processes
  (``torch.multiprocessing``, joined through a ``file://`` store in a
  temporary directory, so parallel test workers never share a port) that
  render and train the lit flagship scene, and checks that every rank's
  loss and gradients are the same.

Not here: the z-brick relay across ranks (the exit opacities by
``all_gather``, the halo rows by send and receive). ``parallel/bricks.py``
drives every brick from one process.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops.cuda_grads import refuse_lookup, voxel_grads_fast
from volume_renderer_tpu_torch.ops.cuda_march import render_rows_fast
from volume_renderer_tpu_torch.parallel.sharding import bands
from volume_renderer_tpu_torch.train import Params, band_loss, merge_params

_ENV_DOC = """A process group over several hosts or cards: start one process a
card with torchrun (every process then calls initialize() with no
arguments), or pass each process the group's address ("host:port" or a
file:// or tcp:// URL), its size and its rank."""


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: DeviceLike = None,
               backend: Optional[str] = None) -> torch.device:
    """Joins this process to the process group and returns the device it
    marches on.

    ``coordinator_address``: "host:port" (a TCP store on rank 0), or a
    ``tcp://`` or ``file://`` URL; None reads ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``env://``). ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``. ``device``: None is card
    ``LOCAL_RANK`` (else the rank) modulo the cards on the host; "cpu" asks
    for the CPU. ``backend``: NCCL for a card and gloo for the CPU unless
    named; gloo also takes a card's ranks (through host copies), which is
    how two ranks share one card, where NCCL puts one rank on a card."""
    if dist.is_initialized():
        raise RuntimeError("this process is already in a process group")
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a group of {world}")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no card, and the CPU was not asked for
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world, rank=rank)
    return dev


def global_mesh(device: torch.device) -> List[torch.device]:
    """The device of every rank, in rank order (``device``: this rank's, as
    ``initialize`` returned it); a device of another host is named as that
    host names it."""
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(device))
    return [torch.device(name) for name in names]


def _on_host(t: torch.Tensor) -> bool:
    """Whether a collective over ``t`` runs on a host copy: gloo reduces and
    gathers CPU tensors."""
    return t.device.type == "cuda" and dist.get_backend() == "gloo"


def all_reduce_sum(tensors: List[torch.Tensor]) -> None:
    """Sums each float32 tensor over the ranks, in place, in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat.cpu() if _on_host(flat) else flat
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    if buf is not flat:
        flat.copy_(buf)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].reshape(t.shape))
        offset += t.numel()


def my_band(opts: RenderOptions) -> tuple:
    """(first row, rows) of this rank's band of image rows."""
    return bands(opts.height, dist.get_world_size())[dist.get_rank()]


def _band_image(scene: Scene, opts: RenderOptions, camera_x_offset: float) -> torch.Tensor:
    """This rank's band of the forward render: one launch of the forward
    kernel on a card (the plain march on the CPU); (rows, W, 3)."""
    y0, rows = my_band(opts)
    if rows == 0:
        return torch.zeros((0, opts.width, 3), dtype=torch.float32, device=scene.device)
    return render_rows_fast(scene, opts, camera_x_offset, y0, rows)


def render_forward_dp(scene: Scene, opts: RenderOptions,
                      camera_x_offset: float = 0.0) -> torch.Tensor:
    """Rays-DP forward render across the ranks: this rank's band, then
    ``all_gather`` of every band (padded to the longest); the whole image
    (H, W, 3) on every rank, equal to ``render_forward_fast``'s bit for bit."""
    band = _band_image(scene, opts, camera_x_offset)
    longest = bands(opts.height, dist.get_world_size())[0][1]
    padded = torch.zeros((longest, opts.width, 3), dtype=torch.float32, device=band.device)
    padded[:band.shape[0]] = band
    buf = padded.cpu() if _on_host(padded) else padded
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, buf)
    return torch.cat(parts)[:opts.height].to(band.device)


def _finish_step(params: Params, optimizer: torch.optim.Optimizer, loss: torch.Tensor,
                 grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sums the band's loss and gradients over the ranks, hands the sums to
    the parameters and steps the optimizer; returns the image's loss."""
    keys = list(params)
    total = [loss.reshape(1).to(torch.float32)] + [grads[k].to(torch.float32) for k in keys]
    all_reduce_sum(total)
    for key, value in zip(keys, total[1:]):
        params[key].grad = value.reshape(params[key].shape)
    optimizer.step()
    return total[0].reshape(())


def train_step_dp(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                  opts: RenderOptions, target: torch.Tensor) -> torch.Tensor:
    """``train.train_step_sharded`` across the ranks: this rank's band loss
    (``train.band_loss`` with the fixed trip count) through
    ``torch.autograd``, the loss and gradients summed over the ranks, one
    optimizer step on every rank. ``params``: this rank's copy, on its
    device; returns the image's loss before the update."""
    y0, rows = my_band(opts)
    optimizer.zero_grad(set_to_none=True)
    target = target.to(torch.float32)
    if rows:
        loss = band_loss(params, scene, opts, target[y0:y0 + rows].to(scene.device), y0, rows,
                         early_exit=False)
        loss.backward()
    else:
        loss = torch.zeros((), device=scene.device)
    with torch.no_grad():
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        return _finish_step(params, optimizer, loss.detach(), grads)


def train_step_fast_dp(params: Params, optimizer: torch.optim.Optimizer, scene: Scene,
                       opts: RenderOptions, target: torch.Tensor,
                       camera_x_offset: float = 0.0) -> torch.Tensor:
    """``parallel.pallas_dp.train_step_fast_sharded`` across the ranks: the
    forward kernel and the scatter kernel over this rank's band (K1 + K3
    unlit, K4 + K6 lit; their plain versions on the CPU), the closed-form
    cotangent ``2 (img - target)``, the loss and gradients summed over the
    ranks, one optimizer step on every rank. Returns the image's loss
    before the update."""
    y0, rows = my_band(opts)
    with torch.no_grad():
        merged = merge_params(params, scene)
        refuse_lookup(merged)
        img = _band_image(merged, opts, camera_x_offset)
        resid = img - target[y0:y0 + rows].to(img.device, torch.float32)
        loss = torch.sum(resid ** 2)
        if rows:
            _, grads = voxel_grads_fast(merged, opts, 2.0 * resid, camera_x_offset, image=img,
                                        y_offset=y0, n_rows=rows)
        else:
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
        return _finish_step(params, optimizer, loss, grads)


# ---------------------------------------------------------------------------
# the local multi-process rehearsal
# ---------------------------------------------------------------------------

# the rehearsal's scene and steps: the JAX package's (multihost.py:_demo_worker)
DEMO = dict(volume=12, width=16, height=16, lr=1e-2)


def demo_problem(device: DeviceLike):
    """(scene, options, target, starting params) of the rehearsal: the lit
    flagship scene at 12^3, a 16 x 16 image of it as the target, and its
    params with the emission scaled by 1.2 and raised by 0.05."""
    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
    from volume_renderer_tpu_torch.utils.flagship import flagship_scene

    scene = flagship_scene(DEMO["volume"], lighting=True, device=device)
    opts = scene.options(DEMO["width"], DEMO["height"])
    target = render_forward_fast(scene, opts)
    params, static = train.split_params(scene)
    with torch.no_grad():
        params["emission"].mul_(1.2).add_(0.05)
    return static, opts, target, params


def _demo_worker(rank: int, world: int, store: str, out_dir: str, device: Optional[str],
                 backend: Optional[str]) -> None:
    """One rank of the rehearsal: joins the group, renders the flagship
    scene rays-DP, takes one Adam step of ``train_step_dp`` and, from the same
    start, one of ``train_step_fast_dp``; saves what it got to
    ``out_dir/rank<r>.pt`` (its traceback to ``rank<r>.err`` if it fails)."""
    from volume_renderer_tpu_torch.ops import cuda_march

    try:
        torch.set_num_threads(1)
        if device == "cuda":
            device = f"cuda:{rank % torch.cuda.device_count()}"
        dev = initialize(store, world, rank, device=device, backend=backend)
        scene, opts, target, start = demo_problem(dev)
        out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(),
               "mesh": [str(d) for d in global_mesh(dev)]}
        cuda_march.reset_launch_counts()
        out["image"] = render_forward_dp(scene, opts).cpu()
        for name, step in (("plain", train_step_dp), ("fast", train_step_fast_dp)):
            params = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
            optimizer = torch.optim.Adam(list(params.values()), lr=DEMO["lr"])
            loss = step(params, optimizer, scene, opts, target)
            out[name] = {"loss": float(loss),
                         "grads": {k: p.grad.cpu() for k, p in params.items()},
                         "params": {k: p.detach().cpu() for k, p in params.items()}}
        out["launches"] = dict(cuda_march.LAUNCHES_BY_MODE)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _same(results: List[dict], get) -> bool:
    first = get(results[0])
    return all(np.array_equal(np.asarray(get(r)), np.asarray(first)) for r in results[1:])


def run_demo(num_processes: int = 2, device: Optional[str] = None,
             backend: Optional[str] = None, timeout: float = 300.0) -> List[dict]:
    """Runs the rehearsal in ``num_processes`` spawned processes, one rank
    each, on ``device`` (None or "cuda": rank r on card r modulo the cards,
    as ``initialize`` picks; "cpu" asks for the CPU), and waits at most ``timeout`` seconds
    for them: a rank still running then is terminated and the call raises
    ``TimeoutError``. Checks that every rank has the same image, losses,
    gradients and updated params, and returns each rank's results in rank
    order (``_demo_worker``)."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="vr_multihost_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_demo_worker,
                             args=(r, num_processes, store, tmp, device, backend))
                 for r in range(num_processes)]
        for p in procs:
            p.start()
        end = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10.0)
        if late:
            raise TimeoutError(f"ranks {late} of the rehearsal did not end within {timeout} s")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            errors = "\n".join(Path(tmp, f"rank{r}.err").read_text()
                               for r in failed if Path(tmp, f"rank{r}.err").exists())
            raise RuntimeError(f"ranks {sorted(failed)} of the rehearsal failed "
                               f"(exit codes {failed}):\n{errors}")
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(num_processes)]
    checks = {"image": lambda r: r["image"]}
    for name in ("plain", "fast"):
        checks[f"{name} loss"] = lambda r, n=name: r[n]["loss"]
        for key in results[0][name]["grads"]:
            checks[f"{name} grad {key}"] = lambda r, n=name, k=key: r[n]["grads"][k]
            checks[f"{name} param {key}"] = lambda r, n=name, k=key: r[n]["params"][k]
    differ = [what for what, get in checks.items() if not _same(results, get)]
    if differ:
        raise AssertionError(f"the ranks of the rehearsal differ in {differ}")
    return results


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demo", action="store_true",
                    help="run the local multi-process rehearsal")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help='"cpu" for a CPU rehearsal (default: the cards)')
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    args = ap.parse_args()
    if args.demo:
        res = run_demo(args.num_processes, args.device, args.backend)
        print(f"multihost demo ({args.num_processes} processes, {res[0]['backend']} on "
              f"{res[0]['mesh']}): plain loss {res[0]['plain']['loss']:.6f}, "
              f"kernel-step loss {res[0]['fast']['loss']:.6f}, every rank equal")
    else:
        print(_ENV_DOC)
