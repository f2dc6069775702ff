"""volume_renderer_tpu_torch: the PyTorch and CUDA port of volume_renderer_tpu.

The module layout and names follow the JAX package. Plain functions work on
float32 tensors with an explicit device; the entry points run on the CUDA
card unless the caller passes ``device="cpu"``, and raise when there is no
card and no device was named. The forward march is one hand-written CUDA
kernel for Hopper (``csrc/march_fwd.cu``) behind ``render_forward_fast``;
``render_forward`` is its plain PyTorch version.
"""

from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.lights import LightSource, pack_lights
from volume_renderer_tpu_torch.models.scene import (
    RenderOptions,
    RenderSettings,
    Scene,
    build_render_options,
)
from volume_renderer_tpu_torch.ops.hg import henyey_greenstein_lut
from volume_renderer_tpu_torch.ops.forward import render_forward
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.api.renderer import StereoRenderMode, VolumeRenderer
from volume_renderer_tpu_torch.convert import scene_from_arrays

__all__ = [
    "Volume",
    "Camera",
    "LightSource",
    "pack_lights",
    "Scene",
    "RenderSettings",
    "RenderOptions",
    "build_render_options",
    "henyey_greenstein_lut",
    "render_forward",
    "render_forward_fast",
    "VolumeRenderer",
    "StereoRenderMode",
    "scene_from_arrays",
]
