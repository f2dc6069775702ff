"""The forward march kernel's wrapper (port of the forward modes of
``volume_renderer_tpu.ops.pallas_march.render_forward_fast``), and what it
shares with the backward kernel's wrapper (``ops/cuda_grads.py``): the
launch counts and the argument struct.

``render_forward_fast`` renders through ``csrc/march_fwd.cu`` when the
scene's tensors lie on a CUDA device: one launch per render, for unlit
scenes (K1), lit scenes with on-the-fly gradients (K4) and lit scenes with
lookup gradient volumes (K5). For a scene on the CPU it runs the plain
version, ``ops.forward.render_rows``. There is no fallback: on a CUDA scene
a failed build, a tensor the kernel does not take or a refused launch
raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import _build
from volume_renderer_tpu_torch.ops.forward import render_rows

# launches of the kernels since the last reset, in all and by mode: the
# forward march (K1, K4, K5), the backward march (K2, K3, K6) and the three
# launch forms of the z-brick march (K7: phase 1 opacity, phase 2 shaded
# segment, gradient segment; ops/cuda_bricks.py)
LAUNCHES = 0
LAUNCHES_BY_MODE: Dict[str, int] = {
    "K1": 0, "K4": 0, "K5": 0, "K2": 0, "K3": 0, "K6": 0,
    "K7_transmittance": 0, "K7_segment": 0, "K7_scatter": 0}

_MODE_IDS = {"K1": 0, "K4": 1, "K5": 2}


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_MODE:
        LAUNCHES_BY_MODE[k] = 0


def count_launch(mode: str) -> None:
    """One more launch of ``mode``; called where a kernel was launched."""
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_MODE[mode] += 1


class _Vol(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("d", ctypes.c_int), ("h", ctypes.c_int),
                ("w", ctypes.c_int)]


class _MarchArgs(ctypes.Structure):
    """Mirror of ``MarchArgs`` in csrc/march_common.cuh."""

    _fields_ = [
        *((role, _Vol) for role in ("em", "ab", "re", "gx", "gy", "gz", "lut")),
        ("rotation", ctypes.c_void_p),
        ("settings", ctypes.c_void_p),
        ("light_pos", ctypes.c_void_p),
        ("light_col", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("steps", ctypes.c_void_p),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("n_lights", ctypes.c_int),
        ("n_steps", ctypes.c_int),
        ("ratio", ctypes.c_float),
        ("cam_off", ctypes.c_float),
        ("focal", ctypes.c_float),
        ("dist", ctypes.c_float),
        ("tstep", ctypes.c_float),
        ("boxmin", ctypes.c_float * 3),
        ("boxmax", ctypes.c_float * 3),
        ("boxscale", ctypes.c_float * 3),
        ("gstep", ctypes.c_float * 3),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("march_fwd")
    if not getattr(lib, "_vr_typed", False):
        lib.vr_march_fwd.argtypes = [ctypes.POINTER(_MarchArgs), ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
        lib.vr_march_fwd.restype = ctypes.c_int
        lib.vr_march_args_size.restype = ctypes.c_size_t
        lib.vr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vr_cuda_error_string.restype = ctypes.c_char_p
        if lib.vr_march_args_size() != ctypes.sizeof(_MarchArgs):
            raise RuntimeError("MarchArgs in csrc/march_common.cuh and its ctypes mirror differ")
        lib._vr_typed = True
    return lib


def kernel_mode(scene: Scene) -> str:
    """Which forward mode the scene needs: K1, K4 or K5."""
    if not scene.has_lighting:
        return "K1"
    return "K5" if scene.has_gradient_volumes else "K4"


def _checked(t: torch.Tensor, name: str, device: torch.device, ndim: int) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the scene on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.ndim != ndim or t.numel() == 0:
        raise ValueError(f"{name} must be a non-empty {ndim}-d tensor, got shape {tuple(t.shape)}")
    return t


def _vol(t: Optional[torch.Tensor], name: str, device: torch.device) -> _Vol:
    if t is None:
        return _Vol(None, 0, 0, 0)
    d, h, w = _checked(t, name, device, 3).shape
    return _Vol(t.data_ptr(), d, h, w)


def _f32(v: float) -> float:
    return float(np.float32(v))


def march_args(scene: Scene, opts: RenderOptions, camera_x_offset: float,
               lookup: bool) -> Tuple[_MarchArgs, torch.Tensor]:
    """The kernels' arguments for a CUDA ``scene`` (``out`` and ``steps``
    left null), checked, and the settings tensor that they point into: keep
    it until the launch is enqueued. ``lookup``: also the gradient volumes.
    """
    dev = scene.device
    lit = scene.has_lighting
    s = scene.settings
    settings = torch.stack([
        _checked(s.factor_emission, "factor_emission", dev, 0),
        _checked(s.factor_absorption, "factor_absorption", dev, 0),
        _checked(s.factor_reflection, "factor_reflection", dev, 0),
        *_checked(s.color, "color", dev, 1).unbind(0),
        _checked(s.opacity_threshold, "opacity_threshold", dev, 0),
    ])
    if settings.shape != (7,):
        raise ValueError("color must have 3 components")
    rotation = _checked(scene.camera.rotation, "camera.rotation", dev, 2)
    if rotation.shape != (3, 3):
        raise ValueError(f"camera.rotation must be (3, 3), got {tuple(rotation.shape)}")

    args = _MarchArgs()
    args.em = _vol(scene.emission.data, "emission", dev)
    args.ab = _vol(None if scene.absorption_aliased else scene.absorption.data, "absorption", dev)
    args.re = args.gx = args.gy = args.gz = args.lut = _Vol(None, 0, 0, 0)
    if lit:
        if not scene.reflection_aliased:
            args.re = _vol(scene.reflection.data, "reflection", dev)
        args.lut = _vol(scene.illumination, "illumination", dev)
        if lookup:
            args.gx = _vol(scene.gradient_x.data, "gradient_x", dev)
            args.gy = _vol(scene.gradient_y.data, "gradient_y", dev)
            args.gz = _vol(scene.gradient_z.data, "gradient_z", dev)
        light_pos = _checked(scene.light_positions, "light_positions", dev, 2)
        light_col = _checked(scene.light_colors, "light_colors", dev, 2)
        if light_pos.shape[1] != 3 or light_col.shape != light_pos.shape:
            raise ValueError("light_positions and light_colors must both be (L, 3)")
        args.light_pos, args.light_col = light_pos.data_ptr(), light_col.data_ptr()
        args.n_lights = light_pos.shape[0]
    args.rotation = rotation.data_ptr()
    args.settings = settings.data_ptr()
    args.width, args.height, args.n_steps = opts.width, opts.height, opts.n_steps
    args.ratio = _f32(np.float32(opts.height) / np.float32(opts.width))
    args.cam_off = _f32(camera_x_offset)
    args.focal = _f32(scene.camera.focal_length)
    args.dist = _f32(scene.camera.distance_to_object)
    args.tstep = _f32(opts.tstep)
    for i in range(3):
        args.boxmin[i] = _f32(opts.boxmin[i])
        args.boxmax[i] = _f32(opts.boxmax[i])
        args.boxscale[i] = _f32(1.0 / (opts.boxmax[i] - opts.boxmin[i]))
        args.gstep[i] = _f32(opts.gradient_step[i])
    return args, settings


def render_forward_fast(scene: Scene, opts: RenderOptions, camera_x_offset: float = 0.0,
                        steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward render, (H, W, 3) float32 on the scene's device.

    On CUDA one launch of the march kernel; on the CPU the plain version.
    If ``steps`` (int32, (H, W), on the scene's device) is given, it
    receives each ray's number of composited samples.
    """
    dev = scene.device
    if dev.type == "cpu":
        return render_rows(scene, opts, camera_x_offset, 0, opts.height, steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"render_forward_fast takes CPU or CUDA scenes, not {dev.type}")

    mode = kernel_mode(scene)
    # settings stays referenced until the launch is enqueued
    args, settings = march_args(scene, opts, camera_x_offset, lookup=mode == "K5")
    out = torch.empty((opts.height, opts.width, 3), dtype=torch.float32, device=dev)
    if steps is not None:
        if (steps.dtype != torch.int32 or steps.device != dev or not steps.is_contiguous()
                or tuple(steps.shape) != (opts.height, opts.width)):
            raise ValueError("steps must be a contiguous int32 (H, W) tensor on the scene's device")
    args.out = out.data_ptr()
    args.steps = None if steps is None else steps.data_ptr()

    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_march_fwd(ctypes.byref(args), _MODE_IDS[mode],
                               int(scene.absorption_aliased), int(scene.reflection_aliased),
                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"march_fwd launch failed: {lib.vr_cuda_error_string(err).decode()}")
    count_launch(mode)
    return out
