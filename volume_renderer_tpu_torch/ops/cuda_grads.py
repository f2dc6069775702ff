"""The backward march kernel's wrapper (port of
``volume_renderer_tpu.ops.pallas_march.voxel_grads_fast`` and
``transfer_grads_fast``).

Given a pixel cotangent ``g`` (H, W, 3), ``voxel_grads_fast`` returns the
image and the gradients of every leaf of ``ops.vjp.split_scene``: the voxel
grids, the transfer factors, the color and, lit, the light colors.
``transfer_grads_fast`` returns the parameters' gradients only and never
touches a grid, for transfer-function fits.

For a scene on a CUDA device both run ``csrc/march_bwd.cu``: one launch per
call, after one launch of the forward kernel unless ``image=`` hands its
output in. Unlit with grids is mode K3, lit (on-the-fly gradients) with
grids K6, parameters only K2. For a scene on the CPU they run the plain
version, ``ops.vjp.replay_backward``. There is no fallback: on a CUDA scene
a failed build, a tensor the kernel does not take or a refused launch
raises. A lit scene with lookup gradient volumes has no backward kernel and
raises on every device; ``ops.vjp.render_fused`` differentiates it.

Both follow the kernel's angle adjoint (``angle_floor=True``, see
``ops.vjp.angle_backward``), on the CPU too, so the two devices agree; the
adjoint of ``render_fused`` is autograd's. They differ only where a normal
is parallel to the view or light direction within 1e-3 rad.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import _build, cuda_march
from volume_renderer_tpu_torch.ops.cuda_march import _MarchArgs, _checked, render_forward_fast
from volume_renderer_tpu_torch.ops.vjp import replay_backward

PARAM_KEYS = ("factor_emission", "factor_absorption", "factor_reflection", "color",
              "light_colors")


class _GradArgs(ctypes.Structure):
    """Mirror of ``GradArgs`` in csrc/march_bwd.cu."""

    _fields_ = [
        ("m", _MarchArgs),
        ("g", ctypes.c_void_p),
        ("image", ctypes.c_void_p),
        ("d_em", ctypes.c_void_p),
        ("d_ab", ctypes.c_void_p),
        ("d_re", ctypes.c_void_p),
        ("planes", ctypes.c_void_p),
        ("angle_floor", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("march_bwd")
    if not getattr(lib, "_vr_typed", False):
        lib.vr_march_bwd.argtypes = [ctypes.POINTER(_GradArgs), ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.vr_march_bwd.restype = ctypes.c_int
        lib.vr_grad_args_size.restype = ctypes.c_size_t
        lib.vr_march_bwd_max_lights.restype = ctypes.c_int
        lib.vr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vr_cuda_error_string.restype = ctypes.c_char_p
        if lib.vr_grad_args_size() != ctypes.sizeof(_GradArgs):
            raise RuntimeError("GradArgs in csrc/march_bwd.cu and its ctypes mirror differ")
        lib._vr_typed = True
    return lib


def grad_mode(scene: Scene, scatter: bool) -> str:
    """Which backward mode a call needs: K2, K3 or K6."""
    if not scatter:
        return "K2"
    return "K6" if scene.has_lighting else "K3"


def march_backward(scene: Scene, opts: RenderOptions, g: torch.Tensor, image: torch.Tensor,
                   camera_x_offset: float = 0.0, scatter: bool = True,
                   angle_floor: bool = True) -> Dict[str, torch.Tensor]:
    """One launch of the backward kernel on a CUDA ``scene``: the gradients
    for the cotangent ``g`` and the forward kernel's ``image``, both
    (H, W, 3). ``scatter=False`` leaves the grids out."""
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError(f"march_backward launches a CUDA kernel; the scene is on {dev}")
    if scene.has_gradient_volumes and scene.has_lighting:
        raise NotImplementedError("no backward kernel for lookup gradient volumes")
    shape = (opts.height, opts.width, 3)
    for name, t in (("g", g), ("image", image)):
        if tuple(_checked(t, name, dev, 3).shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    lit = scene.has_lighting
    lib = _library()
    args = _GradArgs()
    args.m, settings = cuda_march.march_args(scene, opts, camera_x_offset, lookup=False)
    n_lights = args.m.n_lights if lit else 0
    if n_lights > lib.vr_march_bwd_max_lights():
        raise ValueError(f"the backward kernel takes at most {lib.vr_march_bwd_max_lights()} "
                         f"lights, got {n_lights}")

    grids: Dict[str, torch.Tensor] = {}
    if scatter:
        grids["emission"] = torch.zeros_like(scene.emission.data)
        if not scene.absorption_aliased:
            grids["absorption"] = torch.zeros_like(scene.absorption.data)
        if lit and not scene.reflection_aliased:
            grids["reflection"] = torch.zeros_like(scene.reflection.data)
    planes = torch.empty((3 + 3 * n_lights, opts.height, opts.width), dtype=torch.float32,
                         device=dev)
    args.g, args.image, args.planes = g.data_ptr(), image.data_ptr(), planes.data_ptr()
    args.d_em, args.d_ab, args.d_re = (
        grids[k].data_ptr() if k in grids else None
        for k in ("emission", "absorption", "reflection"))
    args.angle_floor = int(angle_floor)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_march_bwd(ctypes.byref(args), int(lit), int(scatter),
                               int(scene.absorption_aliased), int(scene.reflection_aliased),
                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"march_bwd launch failed: {lib.vr_cuda_error_string(err).decode()}")
    cuda_march.count_launch(grad_mode(scene, scatter))

    out = dict(grids)
    if scatter and not scene.reflection_aliased and not lit:
        out["reflection"] = torch.zeros_like(scene.reflection.data)
    out.update(parameter_grads(scene, opts, g, planes))
    return out


def parameter_grads(scene: Scene, opts: RenderOptions, g: torch.Tensor,
                    planes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Closes a backward kernel's per-ray planes (E, F, rac, then 3 per
    light; (2, H, W) with E and F alone for an unlit brick) to the
    parameters' gradients, where the raw colors are at hand. A cotangent of
    mixed sign makes these sums cancel, so they are taken in float64: the
    planes are small."""
    with torch.no_grad():
        s = scene.settings
        n_lights = max(planes.shape[0] - 3, 0) // 3
        ts = cuda_march._f32(opts.tstep)
        g_e = (g.double() * planes[0, :, :, None].double()).sum(dim=(0, 1))  # sum_rays g_c E
        sums = planes[1:].sum(dim=(1, 2), dtype=torch.float64)
        color = s.color.double()
        out = {}
        out["factor_emission"] = ts * torch.dot(g_e, color)
        out["factor_absorption"] = sums[0]
        out["factor_reflection"] = sums[1] if sums.shape[0] > 1 else torch.zeros_like(sums[0])
        out["color"] = s.factor_emission.double() * ts * g_e
        if n_lights:
            p = sums[2:].reshape(n_lights, 3)
            out["light_colors"] = p * color
            out["color"] = out["color"] + (p * scene.light_colors.double()).sum(dim=0)
        return {k: v.float() for k, v in out.items()}


def _grads_fast(scene: Scene, opts: RenderOptions, g, camera_x_offset: float,
                image: Optional[torch.Tensor], scatter: bool):
    if scene.has_lighting and scene.has_gradient_volumes:
        raise NotImplementedError(
            "no fast backward for a lit scene with lookup gradient volumes: differentiate "
            "ops.vjp.render_fused instead")
    dev = scene.device
    g = torch.as_tensor(g, dtype=torch.float32, device=dev).contiguous()
    if image is None:
        image = render_forward_fast(scene, opts, camera_x_offset)
    if dev.type == "cpu":
        grads = replay_backward(scene, opts, g, image, camera_x_offset, angle_floor=True)
        # gradient volumes of an unlit scene are unused: the kernel has no such keys
        grads = {k: v for k, v in grads.items() if not k.startswith("gradient_")}
    else:
        grads = march_backward(scene, opts, g, image, camera_x_offset, scatter=scatter)
    if not scatter:
        grads = {k: v for k, v in grads.items() if k in PARAM_KEYS}
    return image, grads


def voxel_grads_fast(scene: Scene, opts: RenderOptions, g, camera_x_offset: float = 0.0,
                     image: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full backward, pixel -> voxel grids and transfer parameters.

    Returns ``(image, grads)``; ``grads`` has the keys of
    ``ops.vjp.split_scene``: ``emission``, ``absorption`` (if not aliased),
    ``reflection`` (if not aliased; zeros for an unlit scene),
    ``factor_emission``, ``factor_absorption``, ``factor_reflection``,
    ``color`` and, lit, ``light_colors``. The geometry is not
    differentiated.

    Pass ``image`` to reuse a forward render. It must be
    ``render_forward_fast``'s own output for this scene and offset: the
    replay stops where that march stopped, and a foreign image leaves a
    remainder in the absorption gradient.
    """
    return _grads_fast(scene, opts, g, camera_x_offset, image, scatter=True)


def transfer_grads_fast(scene: Scene, opts: RenderOptions, g, camera_x_offset: float = 0.0,
                        image: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Transfer-parameter gradients only: ``(image, {factor_emission,
    factor_absorption, factor_reflection, color[, light_colors]})``, per-ray
    sums without any scatter. ``image`` as for ``voxel_grads_fast``."""
    return _grads_fast(scene, opts, g, camera_x_offset, image, scatter=False)
