"""volume_renderer_tpu_torch: the PyTorch and CUDA port of volume_renderer_tpu.

The module layout and names follow the JAX package. Plain functions work on
float32 tensors with an explicit device; the entry points run on the CUDA
card unless the caller passes ``device="cpu"``, and raise when there is no
card and no device was named. The forward march is one hand-written CUDA
kernel for Hopper (``csrc/march_fwd.cu``) behind ``render_forward_fast``;
``render_forward`` is its plain PyTorch version. The backward march is a
second kernel (``csrc/march_bwd.cu``) behind ``voxel_grads_fast`` and
``transfer_grads_fast``; ``ops.vjp.replay_backward`` is its plain version
and the backward of ``render_fused``. ``train`` holds the training steps.
``parallel.bricks`` cuts the volume along z into bricks over a list of
devices (``parallel.mesh.make_mesh``), each marched by the brick kernels
(``csrc/brick_fwd.cu``, ``csrc/brick_bwd.cu`` behind ``ops/cuda_bricks.py``;
``ops/brick_march.py`` is their plain version); its plain entry points
also take a rows x bricks mesh (``make_mesh_2d``). ``parallel.sharding``
and ``parallel.pallas_dp`` cut the image rows into bands over a list of
devices (rays-DP), a launch of the march kernels a band. ``ops.slab`` sweeps
a volume larger than the device in z-slabs, with the grids on the device
(slabbed) or in host memory (streamed), in plain PyTorch; ``ops.cuda_slab``
runs that sweep through the brick kernels. ``api.planner.plan_render``
picks the tier of a render or training step from the device's memory, for
``VolumeRenderer`` and ``train.train_step_planned``. ``render_oracle`` is the
per-pixel reference march (the facade's ``backend="oracle"``), and
``utils`` holds the stopwatch, the profiler trace and the checkpoints.
``parallel.multihost`` runs rays-DP and the z-brick relay across processes
over ``torch.distributed``, a band or a brick a rank, or a brick and a band
a rank on a rows x bricks mesh (``global_mesh_2d``). ``examples`` holds the
JAX package's example scripts, ported (``python -m
volume_renderer_tpu_torch.examples.example1``).
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
from volume_renderer_tpu_torch.ops.oracle import render_oracle
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.ops.cuda_grads import transfer_grads_fast, voxel_grads_fast
from volume_renderer_tpu_torch.ops.vjp import merge_scene, render_fused, split_scene
from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
from volume_renderer_tpu_torch.parallel.bricks import (
    render_forward_bricked,
    render_forward_bricked_fast,
    render_fused_bricked,
    train_step_fast_bricked,
    voxel_grads_bricked_fast,
)
from volume_renderer_tpu_torch.parallel.sharding import render_forward_sharded
from volume_renderer_tpu_torch.parallel.pallas_dp import (
    render_forward_fast_sharded,
    train_step_fast_sharded,
    voxel_grads_fast_sharded,
)
from volume_renderer_tpu_torch.ops.slab import (
    render_forward_slabbed,
    render_forward_streamed,
    render_fused_slabbed,
    streamed_grads,
)
from volume_renderer_tpu_torch.ops.cuda_slab import (
    render_forward_slabbed_fast,
    render_forward_streamed_fast,
    render_fused_slabbed_fast,
    streamed_grads_fast,
    voxel_grads_slabbed_fast,
)
from volume_renderer_tpu_torch.api.planner import (
    RenderPlan,
    device_memory_budget,
    plan_render,
    scene_volume_bytes,
)
from volume_renderer_tpu_torch.api.renderer import StereoRenderMode, VolumeRenderer
from volume_renderer_tpu_torch.convert import params_from_arrays, scene_from_arrays

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
    "render_oracle",
    "render_forward_fast",
    "render_fused",
    "split_scene",
    "merge_scene",
    "voxel_grads_fast",
    "transfer_grads_fast",
    "train",
    "make_mesh",
    "make_mesh_2d",
    "render_forward_bricked",
    "render_forward_bricked_fast",
    "render_fused_bricked",
    "voxel_grads_bricked_fast",
    "train_step_fast_bricked",
    "render_forward_sharded",
    "render_forward_fast_sharded",
    "voxel_grads_fast_sharded",
    "train_step_fast_sharded",
    "render_forward_slabbed",
    "render_forward_streamed",
    "render_fused_slabbed",
    "streamed_grads",
    "render_forward_slabbed_fast",
    "render_forward_streamed_fast",
    "render_fused_slabbed_fast",
    "voxel_grads_slabbed_fast",
    "streamed_grads_fast",
    "RenderPlan",
    "plan_render",
    "device_memory_budget",
    "scene_volume_bytes",
    "VolumeRenderer",
    "StereoRenderMode",
    "scene_from_arrays",
    "params_from_arrays",
]
