"""Memory planner (port of ``volume_renderer_tpu.api.planner``).

The reference refuses a render that does not fit device memory
(``MManager::checkFreeDeviceMemory``, reference src/C/vr/mm/mmanager.hxx:
144-173). The planner picks a tier instead: it estimates what each tier puts
on the device and takes the first that fits the budget.

Tiers, the port's names against the JAX package's:

================  ===============  ===========================================
port              JAX              route
================  ===============  ===========================================
``"cuda"``        ``"pallas"``     the march kernels on one card
                                   (``ops/cuda_march.py``, ``ops/cuda_grads.py``)
``"plain"``       ``"flat"``       the whole-grid march in plain PyTorch: the
                                   tier of a renderer on the CPU
``"cuda_dp"``     ``"pallas_dp"``  rays-DP over a mesh, a launch a band
                                   (``parallel/pallas_dp.py``)
``"bricked"``     ``"bricked"``    z-bricks over a mesh (``parallel/bricks.py``)
``"slabbed"``     ``"slabbed"``    the z-slab sweep over grids on the device
                                   (``ops/cuda_slab.py``; ``ops/slab.py`` on
                                   the CPU)
``"streamed"``    ``"streamed"``   the z-slab sweep over grids in host memory
================  ===============  ===========================================

The ladder is the JAX package's: the whole-grid tier (with a mesh: rays-DP),
then with a mesh the bricks, then the slabbed sweep, then the streamed one,
then ``ValueError``. On a CUDA device the whole-grid tier is ``"cuda"``:
the kernels take every scene forward, and a plain route on a card would be
a fallback, which the port has none of.

The estimates are the port's own, counted from what it allocates (float32,
bytes):

- the grids the march samples, deduplicated (``scene_volume_bytes``);
- ``"cuda"``: K5's float4 pack of emission and the three gradient volumes,
  four grids made for each render of a lit lookup scene whose four volumes
  have one shape (``ops.cuda_march.pack_lookup``), at its peak: the four
  stacked, then their packed copy, eight grids (``_pack_bytes``). The
  sweeps and the bricks pack the windows likewise for each launch of lit
  phase 2 (``ops.cuda_bricks.pack_window``): eight windows. K2's float2
  pair of emission and absorption, and K2L's of absorption and reflection
  (``ops.cuda_grads.pack_pair``, ``pack_lookup_pair``), are made inside
  ``transfer_grads_fast`` alone, which no tier calls, so they are not
  counted;
- per-ray planes: the kernels' image; the sweeps' and bricks' entry
  records (H, W) int32 and (H, W, 4), opacities, contributions, the carried
  image and their temporaries (``ray_state_bytes``);
- with ``training``: the gradient grids (emission, absorption and
  reflection, each unless aliased, and a lit lookup scene's three gradient
  volumes', as the scatter kernels add into them; K6L reads K5's pack,
  counted above, made once a call), on a card beside them the gradient
  accumulators of a lit lookup scene whose pack exists, four grids and,
  with absorption and reflection separate and of emission's shape, two
  more (K6L's, ``ops.cuda_grads.zero_accumulators``; as many windows a
  brick or a slab for the lookup gradient segment, ``_accumulator_bytes``),
  and the optimizer's grid-sized state, read from ``optimizer`` when one
  is passed, else two a parameter (Adam's moments); the backward's per-ray
  planes;
- for the sweeps: one window (a slab and ``2 * HALO`` halo rows) a role;
  the streamed tier holds two a role on the device, the one that marches
  and the next, copied meanwhile; the slabbed tier's windows are views of
  the grids.

A brick holds ``D / B + 2 * HALO`` rows of each volume (the real halo; the
JAX planner adds 2 rows, ``planner.py:188``), and a depth-1 volume is
copied whole to every brick without denying the tier (the JAX planner
denies it, ``:185``).

JAX's slabbed tier bounds the transients of XLA's gathers, which grow with
the grid. The port's kernels read the grids in place and have no such
transients: on the port that tier saves only K5's pack (the whole-grid
tier's) and the whole-grid training state the sweep does not hold, so for
an unlit scene the ladder goes from ``"cuda"`` to ``"streamed"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike
from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops.brick_march import HALO
from volume_renderer_tpu_torch.ops.cuda_grads import has_pair
from volume_renderer_tpu_torch.ops.cuda_march import is_lookup
from volume_renderer_tpu_torch.parallel.mesh import check_mesh

_F32 = 4

# float32 values a ray holds, by route: the forward kernel's image; the
# backward kernel's image, residual, cotangent, per-ray planes (3, and 3 a
# light) and their float64 closing; the sweeps' and bricks' entry record
# (5), opacities in and out (3), contribution and carried image (6), masks,
# slab bounds and temporaries (about 18 more), and in the backward the
# cotangent, its masked copy, the running dot and the planes (16 more); the
# plain march's per-step temporaries (positions, corner indices, weights)
_RAY_VALUES = {"kernel": 4, "kernel_training": 24, "sweep": 32, "sweep_training": 48,
               "plain": 64, "plain_training": 96}
_PER_LIGHT = 3


def _unique_volumes(scene: Scene) -> List[Tuple[str, Tuple[int, ...]]]:
    """Deduplicated list of (name, shape) of the grids the march samples."""
    vols = [("emission", scene.emission.data)]
    if not scene.absorption_aliased:
        vols.append(("absorption", scene.absorption.data))
    if scene.has_lighting and not scene.reflection_aliased:
        vols.append(("reflection", scene.reflection.data))
    if is_lookup(scene):
        vols.append(("gradient_x", scene.gradient_x.data))
        vols.append(("gradient_y", scene.gradient_y.data))
        vols.append(("gradient_z", scene.gradient_z.data))
    seen = set()
    out = []
    for name, data in vols:
        if id(data) in seen:
            continue
        seen.add(id(data))
        out.append((name, tuple(data.shape)))
    return out


def _nbytes(shape) -> int:
    return int(np.prod(shape)) * _F32


def scene_volume_bytes(scene: Scene) -> int:
    """Deduplicated bytes of all voxel grids the march samples."""
    total = sum(_nbytes(shape) for _, shape in _unique_volumes(scene))
    if scene.has_lighting and scene.illumination is not None:
        total += _nbytes(scene.illumination.shape)
    return total


def ray_state_bytes(opts: RenderOptions, route: str = "kernel", n_lights: int = 0) -> int:
    """Bytes of per-ray state a route holds on the device at once, by its
    name in ``_RAY_VALUES`` (``"kernel"``, ``"sweep"``, ``"plain"``, each
    also ``"..._training"``)."""
    values = _RAY_VALUES[route] + (_PER_LIGHT * n_lights if route.endswith("training") else 0)
    return opts.width * opts.height * _F32 * values


def device_memory_budget(device: DeviceLike = None, default_bytes: int = 12 * 2 ** 30) -> int:
    """Free memory of a CUDA ``device`` (``torch.cuda.mem_get_info``, the
    reference's cudaMemGetInfo), else ``default_bytes``: the JAX package's
    default, taken for a renderer on the CPU."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[0])
    return int(default_bytes)


def optimizer_slots(optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Parameter-sized tensors that ``optimizer`` keeps a parameter: counted
    in its state once it has one, else from its kind (SGD: 1 with momentum,
    else 0); 2, Adam's moments, for any other optimizer and for none."""
    if optimizer is None:
        return 2
    counts = [sum(1 for v in state.values() if torch.is_tensor(v) and v.dim() > 0)
              for state in optimizer.state.values()]
    if counts:
        return max(counts)
    if isinstance(optimizer, torch.optim.SGD):
        return int(any(group.get("momentum", 0) for group in optimizer.param_groups))
    return 2


@dataclass(frozen=True)
class RenderPlan:
    """The tier a render or training step takes. ``path``: ``"cuda"``,
    ``"plain"``, ``"slabbed"`` or ``"streamed"`` on one device, ``"cuda_dp"``
    or ``"bricked"`` over a mesh (the module docstring maps them to the JAX
    package's names). ``est_bytes``: what the tier puts on a device, against
    ``budget_bytes`` (after the headroom)."""

    path: str
    n_slabs: int = 1
    est_bytes: int = 0
    budget_bytes: int = 0
    note: str = ""
    n_devices: int = 1

    def __str__(self):
        note = f", note={self.note!r}" if self.note else ""
        dev = f", n_devices={self.n_devices}" if self.n_devices > 1 else ""
        return (f"RenderPlan({self.path}, n_slabs={self.n_slabs}{dev}, "
                f"est={self.est_bytes / 2 ** 20:.1f} MiB, "
                f"budget={self.budget_bytes / 2 ** 20:.1f} MiB{note})")


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _grad_grid_bytes(scene: Scene) -> int:
    """The scatter kernels' gradient grids: emission, absorption and
    reflection, each unless aliased, and a lit lookup scene's three gradient
    volumes' (``ops.cuda_grads.zero_grids``)."""
    keys = ("emission", "absorption", "reflection")
    if is_lookup(scene):
        keys += ("gradient_x", "gradient_y", "gradient_z")
    return sum(_nbytes(getattr(scene, k).data.shape) for k in keys if getattr(scene, k) is not None)


def _trained_bytes(scene: Scene) -> int:
    """The grids a training step updates: emission and, unless aliased,
    absorption (``train.split_params``)."""
    return sum(_nbytes(getattr(scene, k).data.shape)
               for k in ("emission", "absorption") if getattr(scene, k) is not None)


def _pack_bytes(scene: Scene, rows: Optional[int] = None) -> int:
    """The float4 pack of a lit lookup scene whose emission and gradient
    volumes have one shape, at its peak: ``ops.cuda_march.interleave``
    stacks the four, then copies them packed, eight grids of ``rows`` rows
    each (default: the whole depth). K5's is made for each render, lit
    phase 2's of a window or brick for each launch."""
    if not is_lookup(scene):
        return 0
    shapes = {tuple(getattr(scene, k).data.shape)
              for k in ("emission", "gradient_x", "gradient_y", "gradient_z")}
    if len(shapes) != 1:
        return 0
    d, *plane = scene.emission.data.shape
    return 8 * (d if rows is None else rows) * _nbytes(plane)


def _accumulator_bytes(scene: Scene, rows: Optional[int] = None) -> int:
    """The gradient accumulators into which K6L (the whole depth) and the
    lookup gradient segment (a window or brick of ``rows`` rows) add their
    cotangents where the pack exists: emission's and the gradient volumes',
    four grids, and absorption's and reflection's, two more where
    ``ops.cuda_grads.has_pair``; alive beside the grids they are unpacked
    into."""
    four = _pack_bytes(scene, rows) // 2
    return four + (four // 2 if four and has_pair(scene) else 0)


def _lights(scene: Scene) -> int:
    return int(scene.light_positions.shape[0]) if scene.has_lighting else 0


def brick_grid_bytes(scene: Scene, n_devices: int) -> Optional[int]:
    """The grids of one brick of ``n_devices``: ``D / B + 2 * HALO`` rows of
    every cut volume, a depth-1 volume whole; None where ``n_devices`` does
    not divide a depth or leaves bricks thinner than ``HALO``."""
    uniq = _unique_volumes(scene)
    if any(shape[0] != 1 and (shape[0] % n_devices or shape[0] // n_devices < HALO)
           for _, shape in uniq):
        return None
    return sum(_nbytes(shape) if shape[0] == 1
               else (shape[0] // n_devices + 2 * HALO) * _nbytes(shape[1:])
               for _, shape in uniq)


def tier_bytes(scene: Scene, opts: RenderOptions, path: str, *, n_slabs: int = 1,
               n_devices: int = 1, training: bool = False,
               optimizer: Optional[torch.optim.Optimizer] = None,
               device: DeviceLike = "cuda") -> Optional[int]:
    """What tier ``path`` puts on one device for ``scene`` marched on
    ``device`` (the kernels on a CUDA device, plain PyTorch on the CPU):
    the estimate ``plan_render`` holds against the budget. None where the
    tier cannot take the scene (``n_slabs`` or ``n_devices`` does not divide
    a depth, a slab and its halo exceed it, bricks thinner than ``HALO``)."""
    route = "kernel" if torch.device(device).type == "cuda" else "plain"
    suffix = "_training" if training else ""
    n_lights = _lights(scene)
    uniq = _unique_volumes(scene)
    vol = scene_volume_bytes(scene)
    lut = _nbytes(scene.illumination.shape) if scene.has_lighting else 0
    slots = optimizer_slots(optimizer)
    grad_state = _grad_grid_bytes(scene) + slots * _trained_bytes(scene) if training else 0

    def acc(rows: Optional[int] = None) -> int:
        """The scatter kernels' accumulators, in their training steps."""
        return _accumulator_bytes(scene, rows) if training and route == "kernel" else 0

    sweep_rays = ray_state_bytes(opts, ("sweep" if route == "kernel" else "plain") + suffix,
                                 n_lights)
    if path in ("cuda", "cuda_dp", "plain"):
        pack = _pack_bytes(scene) if path != "plain" else 0
        return vol + pack + grad_state + acc() + ray_state_bytes(opts, route + suffix, n_lights)
    if path == "bricked":
        # one brick a device; the relay's stacked (B, H, W) opacities and
        # dots on the first; training adds the brick's halo-padded gradient
        # grids and the optimizer's state of its part
        brick = brick_grid_bytes(scene, n_devices)
        if brick is None:
            return None
        d = scene.emission.data.shape[0]
        pack = _pack_bytes(scene, d // n_devices + 2 * HALO) if d > 1 else 0
        est = brick + pack + lut + sweep_rays + 2 * _F32 * opts.width * opts.height * n_devices
        grads = (1 + slots) * brick + (acc(d // n_devices + 2 * HALO) if d > 1 else 0)
        return est + (grads if training else 0)
    if path in ("slabbed", "streamed"):
        d = scene.emission.data.shape[0]
        if any(shape[0] % n_slabs for _, shape in uniq) or d // n_slabs + 2 * HALO > d:
            return None
        win = sum((shape[0] // n_slabs + 2 * HALO) * _nbytes(shape[1:]) for _, shape in uniq)
        # the backward's window-shaped gradients, and its accumulator
        slab_grads = win + acc(d // n_slabs + 2 * HALO) if training else 0
        pack = _pack_bytes(scene, d // n_slabs + 2 * HALO)  # lit phase 2's, a window a launch
        if path == "slabbed":  # the windows are views of the grids
            return vol + pack + grad_state + slab_grads + sweep_rays
        # two windows a role; the grids, their gradients and the optimizer
        # stay in host memory
        return 2 * win + pack + lut + slab_grads + sweep_rays
    raise ValueError(f"unknown tier {path!r}")


def plan_render(scene: Scene, opts: RenderOptions, budget_bytes: Optional[int] = None,
                headroom: float = 0.7, training: bool = False, mesh=None,
                optimizer: Optional[torch.optim.Optimizer] = None,
                device: DeviceLike = None) -> RenderPlan:
    """Picks the tier for a render (or, with ``training``, a training step)
    of ``scene`` marched on ``device`` (default: the scene's), with
    ``budget_bytes`` of memory a device (default: ``device_memory_budget``),
    discounted by ``headroom``. ``mesh`` (a list of devices,
    ``parallel.mesh.make_mesh``) unlocks rays-DP when the scene fits a device
    and the bricks when it does not. Only the scene's shapes are read: its
    grids may lie anywhere. ``optimizer``: the training step's, whose state
    is counted (default: Adam's two moments).

    Raises ``ValueError``, the reference's pre-flight error, when not even
    the streamed tier's two windows a role fit."""
    dev = scene.device if device is None else torch.device(device)
    budget = int((budget_bytes if budget_bytes is not None else device_memory_budget(dev))
                 * headroom)
    n_dev = 1 if mesh is None else len(check_mesh(mesh, "band or brick"))
    kw = dict(training=training, optimizer=optimizer, device=dev)

    whole = "plain" if dev.type != "cuda" else ("cuda_dp" if n_dev > 1 else "cuda")
    est_whole = tier_bytes(scene, opts, whole, **kw)
    if est_whole <= budget:
        return RenderPlan(whole, 1, est_whole, budget, n_devices=n_dev if whole == "cuda_dp" else 1)
    if n_dev > 1:
        est = tier_bytes(scene, opts, "bricked", n_devices=n_dev, **kw)
        if est is not None and est <= budget:
            return RenderPlan("bricked", 1, est, budget, n_devices=n_dev)
    best_stream = None
    for n_slabs in _divisors(scene.emission.data.shape[0])[1:]:
        est = tier_bytes(scene, opts, "slabbed", n_slabs=n_slabs, **kw)
        if est is None:
            continue
        if est <= budget:
            return RenderPlan("slabbed", n_slabs, est, budget)
        est = tier_bytes(scene, opts, "streamed", n_slabs=n_slabs, **kw)
        if best_stream is None and est <= budget:
            best_stream = RenderPlan("streamed", n_slabs, est, budget)
    if best_stream is not None:
        return best_stream
    raise ValueError(
        f"scene needs {est_whole / 2 ** 20:.1f} MiB but the budget is {budget / 2 ** 20:.1f} MiB "
        f"and no z-slab split fits; reduce the volume or image size (reference analog: "
        f"mmanager.hxx:144-173)")
