"""The z-brick kernels' wrappers (port of the ``brick`` launches of
``volume_renderer_tpu.ops.pallas_march._launch``, K7).

One brick's three passes, each a function of that brick's tensors:

- ``brick_transmittance``: phase 1, the opacity the brick's own samples
  build up from zero, and every ray's entry record (``brick_march.Entry``:
  the first step the brick owns) (``csrc/brick_fwd.cu``, counted as
  ``K7_transmittance``);
- ``brick_segment``: phase 2, the brick's contribution to the image from its
  entry opacity, and its exit opacity (same source, ``K7_segment``; lit,
  with on-the-fly gradient taps or lookup gradient volumes,
  ``K7_segment_lit``; lookup windows of one shape packed into one float4
  grid for the launch, ``pack_window``);
- ``brick_gradients``: the gradient segment with the scatter into the
  brick's halo-padded grids (``csrc/brick_bwd.cu``, ``K7_scatter``; lit,
  with the reflection grid and the light colors, ``K7_scatter_lit``; lit
  with lookup gradient volumes, also into their three grids,
  ``K7_scatter_lookup``, reading phase 2's packed window where the four
  windows have one shape, and adding emission's and the three windows'
  cotangents into one float4 accumulator of the packed window's shape (and
  absorption's and reflection's into one float2 accumulator, where their
  windows have emission's shape and place), which the wrapper unpacks into
  the padded grids).

Phase 2 and the gradient segment resume every ray from phase 1's record and
require it: nothing walks a ray from step 0 but phase 1, which fetches
absorption alone and is one kernel lit or not.

Each takes a band of image rows, ``n_rows`` from ``y_offset`` (default: the
whole image), as the TPU kernel's ``_launch(band=...)`` does: the launch
marches those rows alone (``MarchArgs.row0``, ``image_height``), every
plane it takes or returns is (n_rows, W), and its rays are the whole
launch's, so a band's results are the whole launch's rows bit for bit (the
gradient segment's grids to the order of its atomic adds). The entry record
is keyed with its band, and a pass refuses a record made for another.

For a brick on a CUDA device each is one kernel launch; for a brick on the
CPU the plain pass of ``ops/brick_march.py``. There is no fallback: on a
CUDA brick a failed build, a tensor the kernel does not take or a refused
launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import _build, brick_march, cuda_march
from volume_renderer_tpu_torch.ops.brick_march import Brick, Entry
from volume_renderer_tpu_torch.ops.cuda_grads import (
    ACC_KEYS, PACK_KEYS, accumulator_pointers, is_lookup, parameter_grads, unpack_accumulator,
    zero_accumulators)
from volume_renderer_tpu_torch.ops.cuda_march import _MarchArgs, _checked


# the lit roles' grids, placed along z as emission and absorption are:
# BrickArgs field prefix -> Scene attribute
_LIT_ROLES = {"re": "reflection", "gx": "gradient_x", "gy": "gradient_y", "gz": "gradient_z"}


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
        *((f"{role}_{field}", ctypes.c_int) for role in _LIT_ROLES
          for field in ("d_global", "z_off")),
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
        ("d_re", ctypes.c_void_p),
        ("d_gx", ctypes.c_void_p),
        ("d_gy", ctypes.c_void_p),
        ("d_gz", ctypes.c_void_p),
        ("d_pack", ctypes.c_void_p),
        ("d_pair", ctypes.c_void_p),
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
    return _typed(_build.load("brick_fwd"), "vr_brick_fwd", _BrickArgs, 5, "vr_brick_args_size",
                  "csrc/brick_common.cuh")


def _bwd_library() -> ctypes.CDLL:
    lib = _typed(_build.load("brick_bwd"), "vr_brick_bwd", _BrickGradArgs, 4,
                 "vr_brick_grad_args_size", "csrc/brick_bwd.cu")
    lib.vr_brick_bwd_max_lights.restype = ctypes.c_int
    return lib


def _cuda_device(brick: Brick, what: str) -> torch.device:
    dev = brick.device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CPU or CUDA bricks, not {dev.type}")
    return dev


def _plane(t: torch.Tensor, name: str, dev: torch.device, opts: RenderOptions, rows: int,
           channels: Optional[int] = None) -> torch.Tensor:
    shape = (rows, opts.width) + (() if channels is None else (channels,))
    if tuple(_checked(t, name, dev, len(shape)).shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return t


def _brick_args(brick: Brick, opts: RenderOptions, camera_x_offset: float, y_offset: int,
                rows: int) -> Tuple[_BrickArgs, torch.Tensor]:
    """The kernels' arguments for a CUDA brick over the band of ``rows``
    image rows from ``y_offset`` (outputs and ``w_in`` left null), and the
    settings tensor they point into: keep it until the launch is enqueued."""
    scene = brick.scene
    lookup = is_lookup(scene)
    args = _BrickArgs()
    args.m, settings = cuda_march.march_args(scene, opts, camera_x_offset, lookup=lookup,
                                             y_offset=y_offset, n_rows=rows)
    args.n_bricks, args.brick = brick.n, brick.index
    args.em_z_off, args.em_d_global = brick.slab_geometry(scene.emission.data)
    if not scene.absorption_aliased:
        args.ab_z_off, args.ab_d_global = brick.slab_geometry(scene.absorption.data)
    if scene.has_lighting:
        roles = {"re": None if scene.reflection_aliased else scene.reflection}
        if lookup:
            roles.update(gx=scene.gradient_x, gy=scene.gradient_y, gz=scene.gradient_z)
        for role, vol in roles.items():
            if vol is not None:
                z_off, d_global = brick.slab_geometry(vol.data)
                setattr(args, f"{role}_z_off", z_off)
                setattr(args, f"{role}_d_global", d_global)
    return args, settings


def _int_plane(t: Optional[torch.Tensor], name: str, dev: torch.device, opts: RenderOptions,
               rows: int):
    """The pointer of an int32 (rows, W) tensor on the brick's device, or None."""
    if t is None:
        return None
    if (t.dtype != torch.int32 or t.device != dev or not t.is_contiguous()
            or tuple(t.shape) != (rows, opts.width)):
        raise ValueError(f"{name} must be a contiguous int32 ({rows}, {opts.width}) tensor on "
                         "the brick's device")
    return t.data_ptr()


def _require_entry(entry: Entry, brick: Brick, opts: RenderOptions, camera_x_offset: float,
                   y_offset: int, rows: int) -> None:
    if not isinstance(entry, Entry):
        raise TypeError("entry must be the brick_march.Entry that brick_transmittance returned "
                        f"for this brick, got {type(entry).__name__}")
    entry.check(Entry.key(brick, opts, camera_x_offset, y_offset, rows))


def _set_entry(args: _BrickArgs, entry: Entry, dev: torch.device, opts: RenderOptions,
               rows: int) -> None:
    state = _plane(entry.state, "entry.state", dev, opts, rows, 4)
    if state.data_ptr() % 16:
        raise ValueError("entry.state must be 16-byte aligned (it is read as float4)")
    args.entry_step = _int_plane(entry.step, "entry.step", dev, opts, rows)
    args.entry_state = state.data_ptr()


def pack_window(brick: Brick) -> Optional[torch.Tensor]:
    """Lit phase 2's and the lookup gradient segment's packed window of a
    lit lookup brick (or slab): its
    emission and three gradient windows as one contiguous float32
    (D_win, H, W, 4) tensor (``ops.cuda_march.interleave``, K5's pack), so
    that the kernel loads a corner of the four at once; rows
    ``[z_off, z_off + D_win)`` of the whole volume's pack, placed as the
    emission window is. None for another scene, or where the four windows
    differ in shape (the kernel then fetches each on its own). Made on the
    brick's device and current stream, for each launch: after a streamed
    window's copy, which that stream waits for."""
    scene = brick.scene
    if not is_lookup(scene):
        return None
    return cuda_march.pack_lookup(scene)


def _set_window_pack(args: _MarchArgs, brick: Brick, packed: Optional[torch.Tensor]) -> None:
    """Points ``args.packed`` at ``packed`` (``pack_window(brick)``),
    checked as the emission window's shape by 4 on the brick's device;
    leaves it null for None."""
    if packed is None:
        return
    want = tuple(brick.scene.emission.data.shape) + (4,)
    _checked(packed, "packed window", brick.device, 4)
    if tuple(packed.shape) != want:
        raise ValueError(f"the packed window must be {want}, got {tuple(packed.shape)}")
    args.packed = cuda_march._Vol4(packed.data_ptr(), *packed.shape[:3])


def _launch_fwd(brick: Brick, opts: RenderOptions, camera_x_offset: float,
                w_in: Optional[torch.Tensor], entry: Optional[Entry],
                steps: Optional[torch.Tensor], y_offset: int, rows: int,
                packed: Optional[torch.Tensor] = None):
    dev = _cuda_device(brick, "the brick march")
    shade = w_in is not None
    # settings: alive until enqueued
    args, settings = _brick_args(brick, opts, camera_x_offset, y_offset, rows)
    w_out = torch.empty((rows, opts.width), dtype=torch.float32, device=dev)
    out = None
    if shade:
        args.w_in = _plane(w_in, "w_in", dev, opts, rows).data_ptr()
        out = torch.empty((rows, opts.width, 3), dtype=torch.float32, device=dev)
        args.m.out = out.data_ptr()
    else:  # phase 1 writes the record
        entry = Entry(torch.empty((rows, opts.width), dtype=torch.int32, device=dev),
                      torch.empty((rows, opts.width, 4), dtype=torch.float32, device=dev),
                      Entry.key(brick, opts, camera_x_offset, y_offset, rows))
    _set_entry(args, entry, dev, opts, rows)
    args.w_out = w_out.data_ptr()
    args.m.steps = _int_plane(steps, "steps", dev, opts, rows)

    scene = brick.scene
    lit = shade and scene.has_lighting
    if lit:  # the pack stays referenced until the launch is enqueued
        _set_window_pack(args.m, brick, pack_window(brick) if packed is None else packed)
    lib = _fwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_brick_fwd(ctypes.byref(args), int(shade), int(scene.absorption_aliased),
                               int(lit), int(lit and scene.has_gradient_volumes),
                               int(scene.reflection_aliased), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"brick_fwd launch failed: {lib.vr_cuda_error_string(err).decode()}")
    cuda_march.count_launch(("K7_segment_lit" if lit else "K7_segment") if shade
                            else "K7_transmittance")
    return out, w_out, entry


def brick_transmittance(brick: Brick, opts: RenderOptions, camera_x_offset: float = 0.0,
                        steps: Optional[torch.Tensor] = None, *, y_offset: int = 0,
                        n_rows: Optional[int] = None) -> Tuple[torch.Tensor, Entry]:
    """Phase 1: the opacity (H, W) that the brick's own samples build up
    from zero, on the brick's device (its transmittance is one minus that),
    and every ray's entry record, which phase 2 and the gradient segment
    take. ``steps`` (int32, (H, W)) receives each ray's number of samples.
    One kernel for every scene: the opacity reads absorption alone. With
    ``n_rows`` (None: to the last row) the band of image rows from
    ``y_offset`` alone, every (H, W) above then (n_rows, W)."""
    rows = cuda_march.band_rows(opts, y_offset, n_rows)
    if brick.device.type == "cpu":
        return brick_march.transmittance_pass(brick, opts, camera_x_offset, steps,
                                              y_offset=y_offset, n_rows=rows)
    _, w, entry = _launch_fwd(brick, opts, camera_x_offset, None, None, steps, y_offset, rows)
    return w, entry


def brick_segment(brick: Brick, opts: RenderOptions, camera_x_offset: float,
                  w_in: torch.Tensor, entry: Entry, steps: Optional[torch.Tensor] = None, *,
                  y_offset: int = 0, n_rows: Optional[int] = None,
                  packed: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: the brick's contribution to the image (H, W, 3) from its
    entry opacity ``w_in`` (H, W), every ray resumed from phase 1's
    ``entry`` record, and its exit opacity (H, W). Lit scenes shade with
    the lights, from the emission taps or the lookup gradient volumes; on a
    CUDA brick those are packed with emission for the launch where the four
    windows have one shape (``pack_window``; ``packed``: that pack, made
    once by a caller that launches the gradient segment on the brick too;
    None packs here). A band as in ``brick_transmittance``, whose record
    for that band it takes."""
    rows = cuda_march.band_rows(opts, y_offset, n_rows)
    _require_entry(entry, brick, opts, camera_x_offset, y_offset, rows)
    if brick.device.type == "cpu":
        return brick_march.shaded_pass(brick, opts, camera_x_offset, w_in, steps,
                                       y_offset=y_offset, n_rows=rows, entry=entry)
    return _launch_fwd(brick, opts, camera_x_offset, w_in, entry, steps, y_offset, rows,
                       packed)[:2]


def brick_gradients(brick: Brick, opts: RenderOptions, camera_x_offset: float,
                    g: torch.Tensor, image: torch.Tensor, w_in: torch.Tensor,
                    up_dot: torch.Tensor, entry: Entry, *, y_offset: int = 0,
                    n_rows: Optional[int] = None,
                    packed: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The gradient segment: the brick's share of every gradient for the
    pixel cotangent ``g`` (H, W, 3), given the GLOBAL ``image``, the brick's
    entry opacity ``w_in``, ``up_dot``, the sum of ``g . contribution``
    over the bricks in front (both (H, W)), and phase 1's ``entry`` record,
    from which every ray resumes. The grids come back halo-padded
    like the brick's own (``reflection`` zeros for an unlit scene), the
    parameters (``factor_emission``, ``factor_absorption``,
    ``factor_reflection``, ``color`` and, lit, ``light_colors``) as this
    brick's term of the sum over bricks: the keys of
    ``ops.cuda_grads.voxel_grads_fast``. A band as in
    ``brick_transmittance``: every (H, W) is the band's, and the grids and
    parameters are the band's share. A lit scene with lookup gradient
    volumes also gets ``gradient_x``, ``gradient_y`` and ``gradient_z``,
    halo-padded like its windows (on a CUDA brick from the packed window,
    ``pack_window``, where the four windows have one shape; ``packed`` as
    in ``brick_segment``)."""
    scene = brick.scene
    lookup = is_lookup(scene)
    rows = cuda_march.band_rows(opts, y_offset, n_rows)
    _require_entry(entry, brick, opts, camera_x_offset, y_offset, rows)
    if brick.device.type == "cpu":
        grads = brick_march.replay_pass(brick, opts, camera_x_offset, g, image, w_in, up_dot,
                                        angle_floor=True, y_offset=y_offset, n_rows=rows,
                                        entry=entry)
        if lookup:
            return grads
        return {k: v for k, v in grads.items() if not k.startswith("gradient_")}
    dev = _cuda_device(brick, "the brick gradient segment")
    args = _BrickGradArgs()
    # settings: alive until enqueued
    args.b, settings = _brick_args(brick, opts, camera_x_offset, y_offset, rows)
    args.b.w_in = _plane(w_in, "w_in", dev, opts, rows).data_ptr()
    _set_entry(args.b, entry, dev, opts, rows)
    args.g = _plane(g, "g", dev, opts, rows, 3).data_ptr()
    args.image = _plane(image, "image", dev, opts, rows, 3).data_ptr()
    args.up_dot = _plane(up_dot, "up_dot", dev, opts, rows).data_ptr()
    lit = scene.has_lighting
    lib = _bwd_library()
    n_lights = args.b.m.n_lights if lit else 0
    if n_lights > lib.vr_brick_bwd_max_lights():
        raise ValueError(f"the lit gradient segment takes at most "
                         f"{lib.vr_brick_bwd_max_lights()} lights, got {n_lights}")
    packed = pack_window(brick) if packed is None else packed  # alive until enqueued
    _set_window_pack(args.b.m, brick, packed)
    # from the packed window, emission's and the gradient windows' cotangents
    # go into one float4 accumulator of its shape, and absorption's and
    # reflection's, windows of emission's shape (so of its place), into one
    # float2 accumulator
    accs = zero_accumulators(scene) if packed is not None else []
    if accs:
        args.d_pack, args.d_pair = accumulator_pointers(accs, scene.emission.data.shape, dev)
    accumulated = {k for acc in accs for k in ACC_KEYS[acc.shape[-1]]}
    roles = ("emission", "absorption", "reflection") + (PACK_KEYS[1:] if lookup else ())
    grids = {k: torch.zeros_like(getattr(scene, k).data) for k in roles
             if getattr(scene, k) is not None and k not in accumulated}
    planes = torch.empty(((3 + 3 * n_lights) if lit else 2, rows, opts.width),
                         dtype=torch.float32, device=dev)
    args.d_em, args.d_gx, args.d_gy, args.d_gz, args.d_ab = (
        grids[k].data_ptr() if k in grids else None for k in PACK_KEYS + ("absorption",))
    # the lit form fills reflection's; unlit it stays zero
    args.d_re = grids["reflection"].data_ptr() if lit and "reflection" in grids else None
    args.planes = planes.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vr_brick_bwd(ctypes.byref(args), int(scene.absorption_aliased), int(lit),
                               int(lookup), int(scene.reflection_aliased),
                               ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"brick_bwd launch failed: {lib.vr_cuda_error_string(err).decode()}")
    cuda_march.count_launch("K7_scatter_lookup" if lookup
                            else "K7_scatter_lit" if lit else "K7_scatter")
    if accs:
        for acc in accs:
            unpack_accumulator(acc, grids)
        del accs, acc
        grids = {k: grids[k] for k in roles if k in grids}  # the keys' order without a pack

    grids.update(parameter_grads(scene, opts, g, planes))
    return grids
