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
grids K6, parameters only K2; unlit K2 reads emission and absorption of one
shape from one grid packed for the call (``pack_pair``). A lit scene with
lookup gradient volumes takes K6L with grids (``gradient_x``, ``gradient_y``
and ``gradient_z`` among them) and K2L without: K5's step replayed, from
K5's float4 grid (``ops.cuda_march.pack_lookup``) made once a call where the
four volumes have one shape. There K6L adds emission's and the gradient
volumes' cotangents into one float4 accumulator of the pack's layout and,
where absorption and reflection are separate and of emission's shape,
theirs into one float2 accumulator (``zero_accumulators``), a vector
reduction a corner each, which the wrapper unpacks into the grids
(``unpack_accumulator``); K2L reads those two from one float2 grid packed
for the call (``pack_lookup_pair``, ``k2l_form``), at the pack's cell. For
a scene on the CPU they run the plain
version, ``ops.vjp.replay_backward``. There is no fallback: on a CUDA scene
a failed build, a tensor the kernel does not take or a refused launch
raises.

Both follow the kernel's angle adjoint (``angle_floor=True``, see
``ops.vjp.angle_backward``), on the CPU too, so the two devices agree; the
adjoint of ``render_fused`` is autograd's. They differ only where a normal
is parallel to the view or light direction within 1e-3 rad.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import _build, cuda_march
from volume_renderer_tpu_torch.ops.cuda_march import (
    _MarchArgs, _Vol2, _checked, band_rows, interleave, is_lookup, render_rows_fast)
from volume_renderer_tpu_torch.ops.vjp import replay_backward
from volume_renderer_tpu_torch.utils.profiling import span

PARAM_KEYS = ("factor_emission", "factor_absorption", "factor_reflection", "color",
              "light_colors")
# the grids whose cotangents K6L and the lookup gradient segment add into an
# accumulator, by channel: the float4 one's are K5's pack's channels, the
# float2 one's absorption and reflection
PACK_KEYS = ("emission", "gradient_x", "gradient_y", "gradient_z")
PAIR_KEYS = ("absorption", "reflection")
ACC_KEYS = {4: PACK_KEYS, 2: PAIR_KEYS}  # by an accumulator's channels


class _GradArgs(ctypes.Structure):
    """Mirror of ``GradArgs`` in csrc/march_bwd.cu."""

    _fields_ = [
        ("m", _MarchArgs),
        ("pair", _Vol2),
        ("g", ctypes.c_void_p),
        ("image", ctypes.c_void_p),
        ("d_em", ctypes.c_void_p),
        ("d_ab", ctypes.c_void_p),
        ("d_re", ctypes.c_void_p),
        ("d_gx", ctypes.c_void_p),
        ("d_gy", ctypes.c_void_p),
        ("d_gz", ctypes.c_void_p),
        ("d_pack", ctypes.c_void_p),
        ("d_pair", ctypes.c_void_p),
        ("planes", ctypes.c_void_p),
        ("angle_floor", ctypes.c_int),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("march_bwd")
    if not getattr(lib, "_vr_typed", False):
        lib.vr_march_bwd.argtypes = [ctypes.POINTER(_GradArgs), ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.vr_march_bwd.restype = ctypes.c_int
        lib.vr_grad_args_size.restype = ctypes.c_size_t
        lib.vr_march_bwd_max_lights.restype = ctypes.c_int
        lib.vr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vr_cuda_error_string.restype = ctypes.c_char_p
        if lib.vr_grad_args_size() != ctypes.sizeof(_GradArgs):
            raise RuntimeError("GradArgs in csrc/march_bwd.cu and its ctypes mirror differ")
        lib._vr_typed = True
    return lib


def pack_pair(scene: Scene) -> Optional[torch.Tensor]:
    """Unlit K2's packed grid: emission and absorption as one contiguous
    float32 (D, H, W, 2) tensor, channels (emission, absorption), so that
    the kernel loads a corner of both at once. Made for each call; None
    where absorption is aliased to emission or has another shape (the
    kernel then fetches each volume on its own)."""
    if scene.absorption_aliased:
        return None
    return interleave([scene.emission.data, scene.absorption.data])


def pack_lookup_pair(scene: Scene) -> Optional[torch.Tensor]:
    """K2L's packed pair: absorption and reflection as one contiguous
    float32 (D, H, W, 2) tensor, channels ``PAIR_KEYS`` (absorption,
    reflection), so that the kernel loads a corner of both at once at the
    cell of K5's pack. Made for each call, as ``pack_pair`` is for unlit K2;
    None unless ``k2l_form`` is "paired" (the kernel then samples each
    volume at a cell of its own)."""
    if k2l_form(scene) != "paired":
        return None
    return interleave([scene.absorption.data, scene.reflection.data])


def grad_mode(scene: Scene, scatter: bool) -> str:
    """Which backward mode a call needs: K2, K3 or K6; K2L or K6L for a lit
    lookup scene."""
    if is_lookup(scene):
        return "K6L" if scatter else "K2L"
    if not scatter:
        return "K2"
    return "K6" if scene.has_lighting else "K3"


def _grid_volumes(scene: Scene) -> Dict[str, torch.Tensor]:
    """The volumes that have a gradient grid beside the scatter kernels'
    (K3, K6, K6L): emission, absorption and reflection, each unless aliased,
    and a lit lookup scene's three gradient volumes. Only the lit kernels
    fill reflection's; an unlit scene's stays zero."""
    roles = ("emission", "absorption", "reflection")
    if is_lookup(scene):
        roles += ("gradient_x", "gradient_y", "gradient_z")
    return {k: getattr(scene, k).data for k in roles if getattr(scene, k) is not None}


def zero_grids(scene: Scene) -> Dict[str, torch.Tensor]:
    """The zeroed gradient grids that the scatter kernels (K3, K6, K6L) add
    into (an unlit scene's reflection grid among them, left at zero)."""
    return {k: torch.zeros_like(v) for k, v in _grid_volumes(scene).items()}


def has_pair(scene: Scene) -> bool:
    """Absorption and reflection separate and of emission's shape: beside the
    pack, K6L and the lookup gradient segment add their cotangents into one
    float2 accumulator at emission's cell, and K2L reads them from one float2
    grid (``pack_lookup_pair``)."""
    return (not scene.absorption_aliased and not scene.reflection_aliased
            and scene.absorption.data.shape == scene.emission.data.shape
            == scene.reflection.data.shape)


def has_pack(scene: Scene) -> bool:
    """Emission and the three gradient volumes of one shape: where K5's
    float4 pack exists (``ops.cuda_march.pack_lookup``)."""
    shape = scene.emission.data.shape
    return all(getattr(scene, k).data.shape == shape for k in PACK_KEYS)


def k2l_form(scene: Scene) -> Optional[str]:
    """The form of K2L that ``march_backward`` launches for a lit lookup
    scene: "paired" (the pack, and absorption and reflection read from
    ``pack_lookup_pair``'s grid at its cell) where ``has_pack`` and
    ``has_pair``, "unpaired" (the pack; absorption and reflection sampled
    each at its own cell) where only ``has_pack``, "unpacked" (each volume
    at its own cell) otherwise; None for any other scene."""
    if not is_lookup(scene):
        return None
    if not has_pack(scene):
        return "unpacked"
    return "paired" if has_pair(scene) else "unpaired"


def zero_accumulators(scene: Scene) -> List[torch.Tensor]:
    """K6L's zeroed gradient accumulators for a lit lookup scene on a CUDA
    device whose emission and gradient volumes have one shape (where K5's
    pack exists): a contiguous float32 (D, H, W, 4) laid out as the pack,
    channel c the cotangent of ``PACK_KEYS[c]``, and, where ``has_pair``, a
    (D, H, W, 2) of ``PAIR_KEYS``. Made once by a caller whose calls share
    one set of grids; empty for any other scene."""
    if scene.device.type != "cuda" or not is_lookup(scene) or not has_pack(scene):
        return []
    shape = tuple(scene.emission.data.shape)
    return [torch.zeros(shape + (n,), dtype=torch.float32, device=scene.device)
            for n in ((4, 2) if has_pair(scene) else (4,))]


def unpack_accumulator(acc: torch.Tensor, grids: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """The channels of a gradient accumulator ``acc`` (``zero_accumulators``;
    the lookup gradient segment's of a window's shape) as the grids they
    hold, ``PACK_KEYS`` of a float4 one (..., 4), ``PAIR_KEYS`` of a float2
    one (..., 2): each added into ``grids[key]`` in place where ``grids``
    holds the key, else made a contiguous grid of its own there. Returns
    ``grids`` (a new dict for None). Plain PyTorch on any device."""
    grids = {} if grids is None else grids
    for c, key in enumerate(ACC_KEYS[acc.shape[-1]]):
        if key in grids:
            grids[key].add_(acc[..., c])
        else:
            grids[key] = acc[..., c].contiguous()
    return grids


def accumulator_pointers(accs: List[torch.Tensor], shape: Tuple[int, ...],
                         device: torch.device) -> Tuple[Optional[int], Optional[int]]:
    """The pointers of the float4 and, if any, the float2 accumulator in
    ``accs``, each checked as ``shape`` (the grids') by its channels on
    ``device``, contiguous and aligned to its vector (it is reduced into as
    float4 or float2)."""
    ptrs = {4: None, 2: None}
    for acc in accs:
        n = _checked(acc, "a gradient accumulator", device, 4).shape[-1]
        if n not in ptrs or ptrs[n] is not None or tuple(acc.shape) != tuple(shape) + (n,):
            raise ValueError(f"the gradient accumulators must be one {tuple(shape) + (4,)} "
                             f"and at most one {tuple(shape) + (2,)}, got {tuple(acc.shape)}")
        if acc.data_ptr() % (4 * n):
            raise ValueError(f"a gradient accumulator must be {4 * n}-byte aligned")
        ptrs[n] = acc.data_ptr()
    if ptrs[4] is None:
        raise ValueError("the float2 accumulator goes beside a float4 one")
    return ptrs[4], ptrs[2]


def march_backward(scene: Scene, opts: RenderOptions, g: torch.Tensor, image: torch.Tensor,
                   camera_x_offset: float = 0.0, scatter: bool = True,
                   angle_floor: bool = True, y_offset: int = 0, n_rows: Optional[int] = None,
                   grids: Optional[Dict[str, torch.Tensor]] = None,
                   packed: Optional[torch.Tensor] = None,
                   accumulators: Optional[List[torch.Tensor]] = None,
                   pair: Optional[torch.Tensor] = None,
                   ) -> Dict[str, torch.Tensor]:
    """One launch of the backward kernel on a CUDA ``scene``: the gradients
    for the cotangent ``g`` and the forward kernel's ``image``, both
    (n_rows, W, 3), of the band of ``n_rows`` image rows from ``y_offset``
    (default: the whole image). ``scatter=False`` leaves the grids out.
    ``grids`` (``zero_grids(scene)``, shared by several bands' calls on one
    device) receives the scatter and is returned; None makes new ones.
    ``packed`` (K2L, K6L): ``ops.cuda_march.pack_lookup(scene)``, made once
    by a caller that launches several bands or the forward too; None packs
    here. K6L from the pack scatters emission's and the gradient volumes'
    cotangents into a float4 accumulator (and absorption's and reflection's
    into a float2 one, ``has_pair``), which this call makes and unpacks into
    the grids; ``accumulators`` (``zero_accumulators(scene)``, with
    ``grids``) are ones shared by several bands' calls instead, which the
    caller unpacks into ``grids`` once after the last
    (``unpack_accumulator``). ``pair``: the call's packed pair, unlit K2's
    (``pack_pair``) or K2L's paired form's (``pack_lookup_pair``), made by
    the caller; None packs here where the mode takes one."""
    with span("march.backward"):
        dev = scene.device
        if dev.type != "cuda":
            raise ValueError(f"march_backward launches a CUDA kernel; the scene is on {dev}")
        n_rows = band_rows(opts, y_offset, n_rows)
        shape = (n_rows, opts.width, 3)
        for name, t in (("g", g), ("image", image)):
            if tuple(_checked(t, name, dev, 3).shape) != shape:
                raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        lit, lookup = scene.has_lighting, is_lookup(scene)
        lib = _library()
        args = _GradArgs()
        args.m, settings = cuda_march.march_args(scene, opts, camera_x_offset, lookup=lookup,
                                                 y_offset=y_offset, n_rows=n_rows)
        if lookup:  # the pack stays referenced until the launch is enqueued
            packed = cuda_march.pack_lookup(scene) if packed is None else packed
            cuda_march.set_packed(args.m, scene, packed)
        n_lights = args.m.n_lights if lit else 0
        if n_lights > lib.vr_march_bwd_max_lights():
            raise ValueError(f"the backward kernel takes at most {lib.vr_march_bwd_max_lights()} "
                             f"lights, got {n_lights}")

        accs = []  # K6L from the pack: the accumulators
        if scatter and lookup and packed is not None:
            accs = zero_accumulators(scene) if accumulators is None else accumulators
            args.d_pack, args.d_pair = accumulator_pointers(accs, scene.emission.data.shape, dev)
        elif accumulators:
            raise ValueError("accumulators are taken by K6L from the packed grid alone")
        accumulated = {k for acc in accs for k in ACC_KEYS[acc.shape[-1]]}
        if not scatter:
            grids = {}
        elif grids is None:
            if accumulators is not None:
                raise ValueError("shared accumulators need the grids they are unpacked into")
            # the accumulated grids come from the accumulators
            grids = {k: torch.zeros_like(v) for k, v in _grid_volumes(scene).items()
                     if k not in accumulated}
        else:
            for key, volume in _grid_volumes(scene).items():
                if key not in grids or grids[key].shape != volume.shape:
                    raise ValueError(f"grids must hold a {key} grid of shape {tuple(volume.shape)}")
                _checked(grids[key], f"the {key} gradient grid", dev, 3)
        planes = torch.empty((3 + 3 * n_lights, n_rows, opts.width), dtype=torch.float32,
                             device=dev)
        # the pair, unlit K2's or K2L's, stays referenced until the launch is enqueued
        form = k2l_form(scene) if not scatter else None
        if not (lit or scatter):
            pair, what = pack_pair(scene) if pair is None else pair, "emission and absorption"
        elif form == "paired":
            pair, what = (pack_lookup_pair(scene) if pair is None else pair,
                          "absorption and reflection")
        elif pair is not None:
            raise ValueError("a pair is taken by unlit K2 and K2L's paired form alone")
        if pair is not None:
            shape = tuple(scene.emission.data.shape) + (2,)
            if tuple(_checked(pair, f"the packed {what}", dev, 4).shape) != shape:
                raise ValueError(f"the packed {what} must be {shape}, got {tuple(pair.shape)}")
            if pair.data_ptr() % 8:
                raise ValueError(f"the packed {what} must be 8-byte aligned")
            args.pair = _Vol2(pair.data_ptr(), *shape[:3])
        args.g, args.image, args.planes = g.data_ptr(), image.data_ptr(), planes.data_ptr()
        # an accumulated grid's cotangents go into its accumulator
        args.d_em, args.d_gx, args.d_gy, args.d_gz, args.d_ab = (
            grids[k].data_ptr() if k in grids and k not in accumulated else None
            for k in PACK_KEYS + ("absorption",))
        # K3 has no reflection term: an unlit scene's reflection grid stays zero
        args.d_re = (grids["reflection"].data_ptr()
                     if lit and "reflection" in grids and "reflection" not in accumulated else None)
        args.angle_floor = int(angle_floor)

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vr_march_bwd(ctypes.byref(args), int(lit), int(scatter), int(lookup),
                                   int(scene.absorption_aliased), int(scene.reflection_aliased),
                                   ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"march_bwd launch failed: {lib.vr_cuda_error_string(err).decode()}")
        cuda_march.count_launch(grad_mode(scene, scatter), form)
        if accumulators is None and accs:
            for acc in accs:
                unpack_accumulator(acc, grids)
            grids = {k: grids[k] for k in _grid_volumes(scene)}  # zero_grids' order

        out = dict(grids)
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
        # a product and a sum, not torch.dot: a cuBLAS call on a band's side
        # stream (parallel/pallas_dp.py) gives that stream a workspace of
        # tens of MiB, kept as long as the stream
        out["factor_emission"] = ts * (g_e * color).sum()
        out["factor_absorption"] = sums[0]
        out["factor_reflection"] = sums[1] if sums.shape[0] > 1 else torch.zeros_like(sums[0])
        out["color"] = s.factor_emission.double() * ts * g_e
        if n_lights:
            p = sums[2:].reshape(n_lights, 3)
            out["light_colors"] = p * color
            out["color"] = out["color"] + (p * scene.light_colors.double()).sum(dim=0)
        return {k: v.float() for k, v in out.items()}


def _grads_fast(scene: Scene, opts: RenderOptions, g, camera_x_offset: float,
                image: Optional[torch.Tensor], scatter: bool, y_offset: int = 0,
                n_rows: Optional[int] = None, grids: Optional[Dict[str, torch.Tensor]] = None,
                packed: Optional[torch.Tensor] = None,
                accumulators: Optional[List[torch.Tensor]] = None):
    dev = scene.device
    n_rows = band_rows(opts, y_offset, n_rows)
    g = torch.as_tensor(g, dtype=torch.float32, device=dev).contiguous()
    if packed is None:
        packed = cuda_march.lookup_pack(scene)  # once for the forward and the backward
    if image is None:
        image = render_rows_fast(scene, opts, camera_x_offset, y_offset, n_rows, packed=packed)
    if dev.type == "cpu":
        grads = replay_backward(scene, opts, g, image, camera_x_offset, y_offset, n_rows,
                                angle_floor=True)
        if not is_lookup(scene):  # an unlit scene's gradient volumes are not sampled
            grads = {k: v for k, v in grads.items() if not k.startswith("gradient_")}
        if scatter and grids is not None:  # add into the caller's grids, as the kernel does
            for key, acc in grids.items():
                grads[key] = acc.add_(grads[key])
    else:
        grads = march_backward(scene, opts, g, image, camera_x_offset, scatter=scatter,
                               y_offset=y_offset, n_rows=n_rows, grids=grids, packed=packed,
                               accumulators=accumulators)
    if not scatter:
        grads = {k: v for k, v in grads.items() if k in PARAM_KEYS}
    return image, grads


def voxel_grads_fast(scene: Scene, opts: RenderOptions, g, camera_x_offset: float = 0.0,
                     image: Optional[torch.Tensor] = None, *, y_offset: int = 0,
                     n_rows: Optional[int] = None,
                     grids: Optional[Dict[str, torch.Tensor]] = None,
                     packed: Optional[torch.Tensor] = None,
                     accumulators: Optional[List[torch.Tensor]] = None,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full backward, pixel -> voxel grids and transfer parameters.

    Returns ``(image, grads)``; ``grads`` has the keys of
    ``ops.vjp.split_scene``: ``emission``, ``absorption`` (if not aliased),
    ``reflection`` (if not aliased; zeros for an unlit scene),
    ``factor_emission``, ``factor_absorption``, ``factor_reflection``,
    ``color`` and, lit, ``light_colors``; a lit scene with lookup gradient
    volumes also ``gradient_x``, ``gradient_y`` and ``gradient_z``. The
    geometry is not differentiated.

    Pass ``image`` to reuse a forward render. It must be
    ``render_forward_fast``'s own output for this scene and offset: the
    replay stops where that march stopped, and a foreign image leaves a
    remainder in the absorption gradient.

    ``y_offset`` and ``n_rows`` replay a band of image rows alone: ``g``
    and ``image`` are then (n_rows, W, 3), and the gradients are the band's
    share. ``grids`` (``zero_grids(scene)``) receives the grids' scatter,
    on every device, so that the bands of one device share one set.
    ``packed``: a lit lookup scene's ``ops.cuda_march.pack_lookup``, made
    once by a caller of several bands (None: one pack a call, on a CUDA
    scene). ``accumulators``: with ``grids``, K6L's accumulators
    (``zero_accumulators(scene)``) shared by the bands, into which the
    accumulated grids' cotangents go until the caller unpacks them into
    ``grids`` (``unpack_accumulator``); None for a CPU scene (the plain
    replay adds into ``grids``).
    """
    return _grads_fast(scene, opts, g, camera_x_offset, image, scatter=True,
                       y_offset=y_offset, n_rows=n_rows, grids=grids, packed=packed,
                       accumulators=accumulators)


def transfer_grads_fast(scene: Scene, opts: RenderOptions, g, camera_x_offset: float = 0.0,
                        image: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Transfer-parameter gradients only: ``(image, {factor_emission,
    factor_absorption, factor_reflection, color[, light_colors]})``, per-ray
    sums without any scatter. ``image`` as for ``voxel_grads_fast``."""
    return _grads_fast(scene, opts, g, camera_x_offset, image, scatter=False)
