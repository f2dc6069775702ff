"""Builds a port ``Scene`` from plain arrays.

``scene_from_arrays`` takes the leaves of a scene as numpy arrays or
numbers: the volumes, the illumination LUT, the lights, the camera and the
render settings. It is how a scene of the JAX package is carried across
(fill the dict with ``np.asarray`` of each leaf there); the port itself
never sees an object of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Union

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
    """
    dev = resolve_device(device)
    unknown = set(arrays) - {*VOLUME_KEYS, *TENSOR_KEYS, *SETTING_KEYS, *CAMERA_KEYS,
                             "element_size_um"}
    if unknown:
        raise KeyError(f"unknown scene keys: {sorted(unknown)}")

    def get(key):
        return arrays.get(key)

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
                           focal_length=float(get("focal_length") or 0.0),
                           distance_to_object=float(get("distance_to_object") or 0.0),
                           device=dev)
    return Scene(camera=camera, settings=settings, **vols, **tensors)
