"""Session-layer renderer facade (port of ``volume_renderer_tpu.api.renderer``).

Mirrors the property surface of the reference's MATLAB ``VolumeRender``
class: off-axis stereo with the reference's height-based disparity, the
pairwise content-equality volume dedup (equal volumes are sampled from one
grid), the default 1x1x1 reflection volume, and the static image and
sequence normalization helpers.

Every render is planned first (``api.planner.plan_render``, from the
volumes' shapes, with ``memory_budget_bytes`` and ``mesh``) and then takes
its tier's route: on a CUDA renderer ``"cuda"`` is the march kernel
(``ops.cuda_march.render_forward_fast``), ``"cuda_dp"`` rays-DP over the
mesh, ``"bricked"`` the z-brick kernels over the mesh, ``"slabbed"`` and
``"streamed"`` the z-slab sweep through the brick kernels
(``ops/cuda_slab.py``); every route takes unlit and lit scenes, the last
three through the lit forms of the brick kernels. On the streamed route the grids stay in host memory, pinned once
and kept, and only their slabs reach the card. A renderer built with
``device="cpu"`` takes the same tiers in plain PyTorch (``"plain"``, the
plain bricked render, the plain slab sweeps), lit scenes included.
``backend="oracle"`` renders every image with ``ops.oracle.render_oracle``
on the renderer's device instead, without a plan.
"""

from __future__ import annotations

import enum
import hashlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike, resolve_device
from volume_renderer_tpu_torch.api.planner import RenderPlan, plan_render
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.lights import LightSource, pack_lights
from volume_renderer_tpu_torch.models.scene import RenderSettings, Scene, build_render_options
from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.ops import cuda_slab, slab
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.ops.oracle import render_oracle
from volume_renderer_tpu_torch.parallel import bricks, pallas_dp
from volume_renderer_tpu_torch.utils.profiling import span


class StereoRenderMode(enum.Enum):
    """Stereo output modes."""

    RED_CYAN = "RedCyan"
    LEFT_RIGHT_HORIZONTAL = "LeftRightHorizontal"


class VolumeRenderer:
    """Stateful facade over the functional render path.

    Attributes mirror VolumeRender.m's properties with the same defaults.
    ``image_resolution`` is (width, height). ``device`` defaults to the
    CUDA card and raises without one.
    """

    def __init__(self, device: DeviceLike = None, backend: str = "forward"):
        if backend not in ("forward", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = resolve_device(device)

        self.focal_length: float = 0.0
        self.distance_to_object: float = 0.0
        self.opacity_threshold: float = 0.95
        self.light_sources: List[LightSource] = []
        self.color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
        self.factor_emission: float = 1.0
        self.factor_reflection: float = 1.0
        self.factor_absorption: float = 1.0
        self.camera_x_offset: float = 0.0
        self.stereo_output: StereoRenderMode = StereoRenderMode.RED_CYAN
        self.element_size_um: Tuple[float, float, float] = (1.0, 1.0, 1.0)
        self.rotation_matrix: torch.Tensor = torch.eye(3, dtype=torch.float32, device=self.device)
        self.image_resolution: Tuple[int, int] = (0, 0)

        self.volume_emission: Optional[Volume] = None
        self.volume_absorption: Optional[Volume] = None
        self.volume_reflection: Optional[Volume] = None
        self.volume_gradient_x: Optional[Volume] = None
        self.volume_gradient_y: Optional[Volume] = None
        self.volume_gradient_z: Optional[Volume] = None
        self.volume_illumination: Optional[torch.Tensor] = None

        # memory planner knobs: None = the device's free memory
        # (api/planner.py); mesh: a list of devices (parallel.mesh.make_mesh)
        # for the rays-DP and z-brick tiers, None = one device
        self.memory_budget_bytes: Optional[int] = None
        self.mesh = None
        self.last_plan: Optional[RenderPlan] = None

        # content hashes for identical-volume dedup, keyed by tensor id with
        # the tensor pinned so that ids cannot be recycled
        self._hash_cache: dict = {}
        # pinned host copies of the streamed route's grids, keyed alike
        self._host_cache: dict = {}

    # ---- scene assembly -------------------------------------------------

    def rotate(self, alpha_deg: float, beta_deg: float, gamma_deg: float) -> None:
        """In-place Euler rotation of the view matrix."""
        cam = Camera.create(rotation=self.rotation_matrix, device=self.device)
        self.rotation_matrix = cam.rotate(alpha_deg, beta_deg, gamma_deg).rotation

    def reset_gradient_volumes(self) -> None:
        """Switch back to on-the-fly gradients."""
        self.volume_gradient_x = None
        self.volume_gradient_y = None
        self.volume_gradient_z = None

    def _content_hash(self, data: torch.Tensor) -> str:
        key = id(data)
        hit = self._hash_cache.get(key)
        if hit is not None and hit[0] is data:
            return hit[1]
        raw = data.detach().to("cpu", torch.float32).contiguous().numpy().tobytes()
        h = hashlib.blake2b(raw, digest_size=16).hexdigest()
        self._hash_cache[key] = (data, h)
        return h

    def _same_volume(self, a: Optional[Volume], b: Optional[Volume]) -> bool:
        """Volume equality as the reference defines it: extents, then contents."""
        if a is None or b is None:
            return False
        if a is b or a.data is b.data:
            return True
        if tuple(a.data.shape) != tuple(b.data.shape):
            return False
        if self._content_hash(a.data) != self._content_hash(b.data):
            return False
        # hash match: confirm with an exact comparison (collision guard)
        return bool(torch.equal(a.data, b.data.to(a.data.device)))

    def _on_device(self, vol: Optional[Volume]) -> Optional[Volume]:
        if vol is None or vol.data.device == self.device:
            return vol
        return vol.replace(data=vol.data.to(self.device))

    def _on_host(self, vol: Optional[Volume]) -> Optional[Volume]:
        """The volume in pinned host memory (pinned once a tensor, and kept)."""
        if vol is None:
            return vol
        key = id(vol.data)
        hit = self._host_cache.get(key)
        if hit is None or hit[0] is not vol.data:
            data = vol.data.detach()
            pinned = data if data.device.type == "cpu" and data.is_pinned() else (
                data.to("cpu").pin_memory())
            hit = self._host_cache[key] = (vol.data, pinned)
        return vol.replace(data=hit[1])

    def _placed(self, scene: Scene, place) -> Scene:
        """``scene`` with ``place`` applied to each of its volumes."""
        return scene.replace(**{k: place(getattr(scene, k)) for k in
                                ("emission", "absorption", "reflection", "gradient_x",
                                 "gradient_y", "gradient_z")})

    def _build_scene(self, resident: bool = True) -> Scene:
        """The scene of the renderer's state, its grids on the renderer's
        device (``resident=False``: where the volumes lie)."""
        if self.volume_emission is None or self.volume_absorption is None:
            raise ValueError("Not all volumes are properly set! "
                             "(emission and absorption are required)")

        # pairwise-equal volumes share one grid (the reference's aliasing)
        absorption = self.volume_absorption
        if self._same_volume(absorption, self.volume_emission):
            absorption = None

        reflection = self.volume_reflection
        if reflection is not None and self._same_volume(reflection, self.volume_emission):
            reflection = None
        elif reflection is None:
            # the reference defaults VolumeReflection to Volume(1)
            reflection = Volume.create(np.ones((1, 1, 1), np.float32), device=self.device)

        grads = (self.volume_gradient_x, self.volume_gradient_y, self.volume_gradient_z)
        if any(g is not None for g in grads) and not all(g is not None for g in grads):
            raise ValueError("All gradient dimensions need to be set!")

        lights_set = len(self.light_sources) > 0 and self.volume_illumination is not None
        illumination = light_pos = light_col = None
        if lights_set:
            light_pos, light_col = pack_lights(self.light_sources, device=self.device)
            illumination = torch.as_tensor(self.volume_illumination, dtype=torch.float32,
                                           device=self.device).contiguous()

        camera = Camera.create(rotation=self.rotation_matrix, focal_length=self.focal_length,
                               distance_to_object=self.distance_to_object, device=self.device)
        settings = RenderSettings.create(
            factor_emission=self.factor_emission,
            factor_reflection=self.factor_reflection,
            factor_absorption=self.factor_absorption,
            color=self.color,
            opacity_threshold=self.opacity_threshold,
            device=self.device,
        )
        emission = self.volume_emission.replace(
            element_size_um=tuple(float(e) for e in self.element_size_um))
        scene = Scene(
            emission=emission,
            absorption=absorption,
            reflection=reflection,
            camera=camera,
            settings=settings,
            gradient_x=self.volume_gradient_x,
            gradient_y=self.volume_gradient_y,
            gradient_z=self.volume_gradient_z,
            illumination=illumination,
            light_positions=light_pos,
            light_colors=light_col,
        )
        return self._placed(scene, self._on_device) if resident else scene

    def _render_once(self, camera_x_offset: float, width: int, height: int) -> torch.Tensor:
        with span("facade.build_scene"):
            scene = self._build_scene(resident=False)
        opts = build_render_options(scene.emission.extent_xyz, scene.emission.element_size_um,
                                    width, height)
        if self.backend == "oracle":
            return render_oracle(scene, opts, camera_x_offset, device=self.device)
        # memory pre-flight from the volumes' shapes, before any grid moves
        # (the reference errors instead, mmanager.hxx:144-173)
        with span("facade.plan"):
            plan = plan_render(scene, opts, budget_bytes=self.memory_budget_bytes,
                               mesh=self.mesh, device=self.device)
        self.last_plan = plan
        kernel = self.device.type == "cuda"
        if plan.path == "streamed":
            if kernel:
                return cuda_slab.render_forward_streamed_fast(
                    self._placed(scene, self._on_host), opts, camera_x_offset,
                    n_slabs=plan.n_slabs, device=self.device)
            return slab.render_forward_streamed(scene, opts, camera_x_offset,
                                                n_slabs=plan.n_slabs, device=self.device)
        if plan.path == "bricked":  # split_bricks copies each brick where it marches
            fn = bricks.render_forward_bricked_fast if kernel else bricks.render_forward_bricked
            return fn(scene, opts, camera_x_offset, mesh=self.mesh)
        scene = self._placed(scene, self._on_device)
        if plan.path == "cuda_dp":
            return pallas_dp.render_forward_fast_sharded(scene, opts, camera_x_offset,
                                                         mesh=self.mesh)
        if plan.path == "slabbed":
            fn = cuda_slab.render_forward_slabbed_fast if kernel else slab.render_forward_slabbed
            return fn(scene, opts, camera_x_offset, n_slabs=plan.n_slabs)
        return render_forward_fast(scene, opts, camera_x_offset)

    # ---- rendering ------------------------------------------------------

    def render(self) -> torch.Tensor:
        """Render to an (H, W, 3) image; stereo if camera_x_offset != 0."""
        with span("facade.render"):
            width, height = (int(v) for v in self.image_resolution)
            if width <= 0 or height <= 0:
                raise ValueError("image_resolution must be set to positive (width, height)")

            if self.camera_x_offset == 0:
                return self._render_once(0.0, width, height)

            # Off-axis stereo: two passes at widened resolution, crop the
            # disparity delta from opposite sides, merge. The reference uses the
            # image HEIGHT in the disparity formula; replicated verbatim.
            base = self.camera_x_offset / 2.0
            fov = 2.0 * np.arctan(1.0 / self.focal_length)
            delta = int(round((base * height) / (2.0 * self.focal_length * np.tan(fov / 2.0))))

            wide = width + delta
            right = self._render_once(base, wide, height)
            left = self._render_once(-base, wide, height)

            left_c = left[:, delta:, :]
            right_c = right[:, : wide - delta, :]

            if self.stereo_output == StereoRenderMode.RED_CYAN:
                return torch.stack([left_c[:, :, 0], right_c[:, :, 1], right_c[:, :, 2]], dim=-1)
            return torch.cat([left_c, right_c], dim=1)

    # ---- introspection --------------------------------------------------

    def mem_info(self) -> str:
        """Human-readable scene memory report (the reference's
        ``MManager::memInfo``): each volume with its shape and size, shared
        volumes counted once, the deduplicated total and, on a card, the
        memory that PyTorch has allocated there."""
        lines = ["volume_renderer_tpu_torch scene memory:"]
        total = 0
        seen = []  # (name, Volume) already counted as resident
        for name in ("volume_emission", "volume_absorption", "volume_reflection",
                     "volume_gradient_x", "volume_gradient_y", "volume_gradient_z"):
            vol = getattr(self, name)
            if vol is None:
                continue
            nbytes = int(np.prod(vol.data.shape)) * 4
            # the render path's pairwise content-equality rule (_same_volume)
            shared_with = next((n for n, v in seen if self._same_volume(vol, v)), None)
            dedup = f" (shared with {shared_with})" if shared_with else ""
            if not shared_with:
                seen.append((name, vol))
                total += nbytes
            lines.append(f"  {name}: shape={tuple(vol.data.shape)} "
                         f"{nbytes / 2 ** 20:.1f} MiB{dedup}")
        if self.volume_illumination is not None:
            nbytes = int(np.prod(self.volume_illumination.shape)) * 4
            total += nbytes
            lines.append(f"  volume_illumination: shape={tuple(self.volume_illumination.shape)} "
                         f"{nbytes / 2 ** 20:.1f} MiB")
        lines.append(f"  total (deduplicated): {total / 2 ** 20:.1f} MiB")
        if self.device.type == "cuda":
            allocated = torch.cuda.memory_allocated(self.device)
            lines.append(f"  device memory_allocated: {allocated / 2 ** 20:.1f} MiB")
        return "\n".join(lines)

    # ---- static helpers -------------------------------------------------

    @staticmethod
    def normalize_image(image_rgb, min_value: Optional[float] = None,
                        max_value: Optional[float] = None) -> torch.Tensor:
        """Normalize an RGB image to [0, 1] (reference semantics, including
        the shift by a negative minimum)."""
        img = torch.as_tensor(image_rgb, dtype=torch.float32)
        if min_value is None:
            min_value = float(torch.min(img))
        if max_value is None:
            max_value = float(torch.max(img))
        if min_value < 0:
            img = img + min_value
            max_value = max_value + abs(min_value)
        return img / max_value

    @staticmethod
    def normalize_sequence(sequence) -> torch.Tensor:
        """Normalize a 4D (H, W, 3, T) sequence globally."""
        seq = torch.as_tensor(sequence, dtype=torch.float32)
        if seq.ndim < 4:
            raise ValueError("input must be a multiframe image (4D)")
        mn = float(torch.min(seq))
        mx = float(torch.max(seq))
        frames = [VolumeRenderer.normalize_image(seq[..., i], mn, mx)
                  for i in range(seq.shape[-1])]
        return torch.stack(frames, dim=-1)
