"""The z-brick kernels' wrappers (port of the ``brick`` launches of
``volume_renderer_tpu.ops.pallas_march._launch``, K7).

One brick's three passes, each a function of that brick's tensors:

- ``brick_transmittance``: phase 1, the opacity the brick's own samples
  build up from zero, and every ray's entry record (``brick_march.Entry``:
  the first step the brick owns) (``csrc/brick_fwd.cu``, counted as
  ``K7_transmittance``);
- ``brick_segment``: phase 2, the brick's contribution to the image from its
  entry opacity, and its exit opacity (same source, ``K7_segment``);
- ``brick_gradients``: the gradient segment with the scatter into the
  brick's halo-padded grids (``csrc/brick_bwd.cu``, ``K7_scatter``).

Phase 2 and the gradient segment resume every ray from phase 1's record and
require it: nothing walks a ray from step 0 but phase 1.

For a brick on a CUDA device each is one kernel launch; for a brick on the
CPU the plain pass of ``ops/brick_march.py``. There is no fallback: on a
CUDA brick a failed build, a tensor the kernel does not take or a refused
launch raises. The kernels march unlit scenes only, as the TPU mode did; a
lit brick raises ``NotImplementedError`` on every device, and
``parallel.bricks.render_forward_bricked`` / ``render_fused_bricked`` serve
lit scenes through the plain passes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions
from volume_renderer_tpu_torch.ops import _build, brick_march, cuda_march
from volume_renderer_tpu_torch.ops.brick_march import Brick, Entry
from volume_renderer_tpu_torch.ops.cuda_grads import parameter_grads
from volume_renderer_tpu_torch.ops.cuda_march import _MarchArgs, _checked


class _BrickArgs(ctypes.Structure):
    """Mirror of ``BrickArgs`` in csrc/brick_common.cuh."""

    _fields_ = [
        ("m", _MarchArgs),
        ("n_bricks", ctypes.c_int),
        ("brick", ctypes.c_int),
        ("em_d_global", ctypes.c_int),
        ("em_z_off", ctypes.c_int),
        ("ab_d_global", ctypes.c_int),
        ("ab_z_off", ctypes.c_int),
        ("w_in", ctypes.c_void_p),
        ("w_out", ctypes.c_void_p),
        ("entry_step", ctypes.c_void_p),
        ("entry_state", ctypes.c_void_p),
    ]


class _BrickGradArgs(ctypes.Structure):
    """Mirror of ``BrickGradArgs`` in csrc/brick_bwd.cu."""

    _fields_ = [
        ("b", _BrickArgs),
        ("g", ctypes.c_void_p),
        ("image", ctypes.c_void_p),
        ("up_dot", ctypes.c_void_p),
        ("d_em", ctypes.c_void_p),
        ("d_ab", ctypes.c_void_p),
        ("planes", ctypes.c_void_p),
    ]


def _typed(lib: ctypes.CDLL, launch: str, args_type, n_ints: int, size_fn: str,
           where: str) -> ctypes.CDLL:
    if not getattr(lib, "_vr_typed", False):
        fn = getattr(lib, launch)
        fn.argtypes = [ctypes.POINTER(args_type), *([ctypes.c_int] * n_ints), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        getattr(lib, size_fn).restype = ctypes.c_size_t
        lib.vr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vr_cuda_error_string.restype = ctypes.c_char_p
        if getattr(lib, size_fn)() != ctypes.sizeof(args_type):
            raise RuntimeError(f"{args_type.__name__[1:]} in {where} and its ctypes mirror differ")
        lib._vr_typed = True
    return lib


def _fwd_library() -> ctypes.CDLL:
    return _typed(_build.load("brick_fwd"), "vr_brick_fwd", _BrickArgs, 2, "vr_brick_args_size",
                  "csrc/brick_common.cuh")


def _bwd_library() -> ctypes.CDLL:
    return _typed(_build.load("brick_bwd"), "vr_brick_bwd", _BrickGradArgs, 1,
                  "vr_brick_grad_args_size", "csrc/brick_bwd.cu")


def _refuse_lit(brick: Brick) -> None:
    if brick.scene.has_lighting:
        raise NotImplementedError(
            "the brick kernels march unlit scenes only: render a lit scene through "
            "parallel.bricks.render_forward_bricked and differentiate it through "
            "parallel.bricks.render_fused_bricked")


def _cuda_device(brick: Brick, what: str) -> torch.device:
    dev = brick.device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CPU or CUDA bricks, not {dev.type}")
    return dev


def _plane(t: torch.Tensor, name: str, dev: torch.device, opts: RenderOptions,
           channels: Optional[int] = None) -> torch.Tensor:
    shape = (opts.height, opts.width) + (() if channels is None else (channels,))
    if tuple(_checked(t, name, dev, len(shape)).shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return t


def _brick_args(brick: Brick, opts: RenderOptions, camera_x_offset: float
                ) -> Tuple[_BrickArgs, torch.Tensor]:
    """The kernels' arguments for a CUDA brick (outputs and ``w_in`` left
    null), and the settings tensor they point into: keep it until the launch
    is enqueued."""
    scene = brick.scene
    args = _BrickArgs()
    args.m, settings = cuda_march.march_args(scene, opts, camera_x_offset, lookup=False)
    args.n_bricks, args.brick = brick.n, brick.index
    args.em_z_off, args.em_d_global = brick.slab_geometry(scene.emission.data)
    if not scene.absorption_aliased:
        args.ab_z_off, args.ab_d_global = brick.slab_geometry(scene.absorption.data)
    return args, settings


def _int_plane(t: Optional[torch.Tensor], name: str, dev: torch.device, opts: RenderOptions):
    """The pointer of an int32 (H, W) tensor on the brick's device, or None."""
    if t is None:
        return None
    if (t.dtype != torch.int32 or t.device != dev or not t.is_contiguous()
            or tuple(t.shape) != (opts.height, opts.width)):
        raise ValueError(f"{name} must be a contiguous int32 (H, W) tensor on the brick's device")
    return t.data_ptr()


def _require_entry(entry: Entry, brick: Brick, opts: RenderOptions,
                   camera_x_offset: float) -> None:
    if not isinstance(entry, Entry):
        raise TypeError("entry must be the brick_march.Entry that brick_transmittance returned "
                        f"for this brick, got {type(entry).__name__}")
    entry.check(Entry.key(brick, opts, camera_x_offset))


def _set_entry(args: _BrickArgs, entry: Entry, dev: torch.device, opts: RenderOptions) -> None:
    state = _plane(entry.state, "entry.state", dev, opts, 4)
    if state.data_ptr() % 16:
        raise ValueError("entry.state must be 16-byte aligned (it is read as float4)")
    args.entry_step = _int_plane(entry.step, "entry.step", dev, opts)
    args.entry_state = state.data_ptr()


def _launch_fwd(brick: Brick, opts: RenderOptions, camera_x_offset: float,
                w_in: Optional[torch.Tensor], entry: Optional[Entry],
                steps: Optional[torch.Tensor]):
    dev = _cuda_device(brick, "the brick march")
    shade = w_in is not None
    args, settings = _brick_args(brick, opts, camera_x_offset)  # settings: alive until enqueued
    w_out = torch.empty((opts.height, opts.width), dtype=torch.float32, device=dev)
    out = None
    if shade:
        args.w_in = _plane(w_in, "w_in", dev, opts).data_ptr()
        out = torch.empty((opts.height, opts.width, 3), dtype=torch.float32, device=dev)
        args.m.out = out.data_ptr()
    else:  # phase 1 writes the record
        entry = Entry(torch.empty((opts.height, opts.width), dtype=torch.int32, device=dev),
                      torch.empty((opts.height, opts.width, 4), dtype=torch.float32, device=dev),
                      Entry.key(brick, opts, camera_x_offset))
    _set_entry(args, entry, dev, opts)
    args.w_out = w_out.data_ptr()
    args.m.steps = _int_plane(steps, "steps", dev, opts)

    lib = _fwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_brick_fwd(ctypes.byref(args), int(shade),
                               int(brick.scene.absorption_aliased), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"brick_fwd launch failed: {lib.vr_cuda_error_string(err).decode()}")
    cuda_march.count_launch("K7_segment" if shade else "K7_transmittance")
    return out, w_out, entry


def brick_transmittance(brick: Brick, opts: RenderOptions, camera_x_offset: float = 0.0,
                        steps: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Entry]:
    """Phase 1: the opacity (H, W) that the brick's own samples build up
    from zero, on the brick's device (its transmittance is one minus that),
    and every ray's entry record, which phase 2 and the gradient segment
    take. ``steps`` (int32, (H, W)) receives each ray's number of samples."""
    _refuse_lit(brick)
    if brick.device.type == "cpu":
        return brick_march.transmittance_pass(brick, opts, camera_x_offset, steps)
    _, w, entry = _launch_fwd(brick, opts, camera_x_offset, None, None, steps)
    return w, entry


def brick_segment(brick: Brick, opts: RenderOptions, camera_x_offset: float,
                  w_in: torch.Tensor, entry: Entry, steps: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: the brick's contribution to the image (H, W, 3) from its
    entry opacity ``w_in`` (H, W), every ray resumed from phase 1's
    ``entry`` record, and its exit opacity (H, W)."""
    _refuse_lit(brick)
    _require_entry(entry, brick, opts, camera_x_offset)
    if brick.device.type == "cpu":
        return brick_march.shaded_pass(brick, opts, camera_x_offset, w_in, steps, entry=entry)
    return _launch_fwd(brick, opts, camera_x_offset, w_in, entry, steps)[:2]


def brick_gradients(brick: Brick, opts: RenderOptions, camera_x_offset: float,
                    g: torch.Tensor, image: torch.Tensor, w_in: torch.Tensor,
                    up_dot: torch.Tensor, entry: Entry) -> Dict[str, torch.Tensor]:
    """The gradient segment: the brick's share of every gradient for the
    pixel cotangent ``g`` (H, W, 3), given the GLOBAL ``image``, the brick's
    entry opacity ``w_in``, ``up_dot``, the sum of ``g . contribution``
    over the bricks in front (both (H, W)), and phase 1's ``entry`` record,
    from which every ray resumes. The grids come back halo-padded
    like the brick's own (``reflection`` zeros), the parameters
    (``factor_emission``, ``factor_absorption``, ``factor_reflection``,
    ``color``) as this brick's term of the sum over bricks."""
    _refuse_lit(brick)
    _require_entry(entry, brick, opts, camera_x_offset)
    scene = brick.scene
    if brick.device.type == "cpu":
        grads = brick_march.replay_pass(brick, opts, camera_x_offset, g, image, w_in, up_dot,
                                        angle_floor=True, entry=entry)
        return {k: v for k, v in grads.items() if not k.startswith("gradient_")}
    dev = _cuda_device(brick, "the brick gradient segment")
    args = _BrickGradArgs()
    args.b, settings = _brick_args(brick, opts, camera_x_offset)  # settings: alive until enqueued
    args.b.w_in = _plane(w_in, "w_in", dev, opts).data_ptr()
    _set_entry(args.b, entry, dev, opts)
    args.g = _plane(g, "g", dev, opts, 3).data_ptr()
    args.image = _plane(image, "image", dev, opts, 3).data_ptr()
    args.up_dot = _plane(up_dot, "up_dot", dev, opts).data_ptr()
    grids = {"emission": torch.zeros_like(scene.emission.data)}
    if not scene.absorption_aliased:
        grids["absorption"] = torch.zeros_like(scene.absorption.data)
    planes = torch.empty((2, opts.height, opts.width), dtype=torch.float32, device=dev)
    args.d_em = grids["emission"].data_ptr()
    args.d_ab = grids["absorption"].data_ptr() if "absorption" in grids else None
    args.planes = planes.data_ptr()

    lib = _bwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_brick_bwd(ctypes.byref(args), int(scene.absorption_aliased),
                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"brick_bwd launch failed: {lib.vr_cuda_error_string(err).decode()}")
    cuda_march.count_launch("K7_scatter")

    if not scene.reflection_aliased:
        grids["reflection"] = torch.zeros_like(scene.reflection.data)
    grids.update(parameter_grads(scene, opts, g, planes))
    return grids
