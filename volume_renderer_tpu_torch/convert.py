"""Builds a port ``Scene``, and its training parameters, from plain arrays.

``scene_from_arrays`` takes the leaves of a scene as numpy arrays or
numbers: the volumes, the illumination LUT, the lights, the camera and the
render settings. It is how a scene of the JAX package is carried across
(fill the dict with ``np.asarray`` of each leaf there); the port itself
never sees an object of the JAX package. ``params_from_arrays`` does the
same for the parameter dict of a training step, whole or, with ``mesh=``,
cut into the per-brick leaves of the z-brick path.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.scene import RenderSettings, Scene
from volume_renderer_tpu_torch.models.volume import Volume

ArrayLike = Union[np.ndarray, float]

# keys of the dict; the first is required, every other may be missing or None
VOLUME_KEYS = ("emission", "absorption", "reflection", "gradient_x", "gradient_y", "gradient_z")
TENSOR_KEYS = ("illumination", "light_positions", "light_colors")
SETTING_KEYS = ("factor_emission", "factor_reflection", "factor_absorption", "color",
                "opacity_threshold")
CAMERA_KEYS = ("rotation", "focal_length", "distance_to_object")


def scene_from_arrays(arrays: Dict[str, ArrayLike], device: DeviceLike = None) -> Scene:
    """A ``Scene`` on ``device`` from ``arrays``.

    Keys: the volumes (``emission`` required; ``absorption``/``reflection``
    None means aliased to emission; ``gradient_x/y/z`` for lookup mode),
    ``illumination``, ``light_positions``, ``light_colors``, ``rotation``,
    ``focal_length``, ``distance_to_object``, the settings fields and
    ``element_size_um`` (of the emission volume).

    ``focal_length`` and ``distance_to_object`` carry the camera's leaves
    across: a number stays a Python float, a numpy array (0-d) becomes a 0-d
    float32 tensor, as the JAX package's camera holds them, which
    ``ops.vjp.split_scene(with_camera=True)`` then keeps.
    """
    dev = resolve_device(device)
    unknown = set(arrays) - {*VOLUME_KEYS, *TENSOR_KEYS, *SETTING_KEYS, *CAMERA_KEYS,
                             "element_size_um"}
    if unknown:
        raise KeyError(f"unknown scene keys: {sorted(unknown)}")

    def get(key):
        return arrays.get(key)

    def get_or_zero(key):
        return 0.0 if get(key) is None else get(key)

    es = tuple(float(e) for e in (get("element_size_um") if get("element_size_um") is not None
                                  else (1.0, 1.0, 1.0)))
    vols = {k: None if get(k) is None else Volume.create(np.array(get(k), np.float32),
                                                         device=dev)
            for k in VOLUME_KEYS}
    vols["emission"] = vols["emission"].replace(element_size_um=es)
    tensors = {k: None if get(k) is None
               else torch.as_tensor(np.array(get(k), np.float32), device=dev).contiguous()
               for k in TENSOR_KEYS}
    settings = RenderSettings.create(
        **{k: np.asarray(get(k), np.float32) for k in SETTING_KEYS if get(k) is not None},
        device=dev)
    camera = Camera.create(rotation=get("rotation"),
                           focal_length=get_or_zero("focal_length"),
                           distance_to_object=get_or_zero("distance_to_object"),
                           device=dev)
    return Scene(camera=camera, settings=settings, **vols, **tensors)


PARAM_KEYS = ("emission", "absorption", "factor_emission", "factor_absorption",
              "factor_reflection", "color")


def params_from_arrays(arrays: Dict[str, ArrayLike], device: DeviceLike = None,
                       mesh: Optional[Sequence[torch.device]] = None):
    """The parameter dict of ``train.split_params`` from numpy: float32 leaf
    tensors on ``device`` that require grad. Keys: ``emission``, the three
    factors, ``color`` and, unless aliased, ``absorption``.

    With ``mesh`` (a list of devices, one per brick) it is the dict of
    ``parallel.bricks.split_params_bricked`` instead: the grids cut along z
    into one leaf per brick, each on its device, the other leaves on
    ``mesh[0]``; ``device`` is then not used."""
    unknown = set(arrays) - set(PARAM_KEYS)
    missing = set(PARAM_KEYS) - {"absorption"} - set(arrays)
    if unknown or missing:
        raise KeyError(f"parameter keys: unknown {sorted(unknown)}, missing {sorted(missing)}")

    def leaf(value, dev):
        return torch.tensor(np.asarray(value, np.float32), device=dev).requires_grad_(True)

    if mesh is None:
        dev = resolve_device(device)
        return {k: leaf(v, dev) for k, v in arrays.items()}
    mesh = [torch.device(d) for d in mesh]
    params = {}
    for key, value in arrays.items():
        if key in ("emission", "absorption"):
            value = np.asarray(value, np.float32)
            if value.shape[0] % len(mesh) != 0:
                raise ValueError(f"{key} depth {value.shape[0]} must be divisible by the "
                                 f"brick mesh size {len(mesh)}")
            params[key] = [leaf(part, dev)
                           for part, dev in zip(np.split(value, len(mesh), axis=0), mesh)]
        else:
            params[key] = leaf(value, mesh[0])
    return params
