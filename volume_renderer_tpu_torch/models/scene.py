"""Scene + render-option derivation (port of ``volume_renderer_tpu.models.scene``).

``build_render_options`` replicates the reference's ``vr::initRender``
exactly, in numpy float32, so the host-side constants match bit for bit:
- render box: boxmax = (1, h*esy/(w*esx), d*esz/(w*esx)), boxmin = -boxmax,
  from the EMISSION volume extent only;
- step size: tstep = 1 / (2.2 * D), D the MINIMUM of the three face
  diagonals (the reference's comment says maximal; its code takes the min);
- gradient step: (1/w, 1/h, 1/d).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch._device import DeviceLike, as_float32, resolve_device
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.volume import Volume


@dataclass(frozen=True, eq=False)
class RenderSettings:
    """Transfer factors + color + opacity threshold, float32 tensors on the
    scene's device (0-d, color (3,)). Defaults: factors 1.0, color white,
    threshold 0.95."""

    factor_emission: torch.Tensor
    factor_reflection: torch.Tensor
    factor_absorption: torch.Tensor
    color: torch.Tensor
    opacity_threshold: torch.Tensor

    @classmethod
    def create(
        cls,
        factor_emission: float = 1.0,
        factor_reflection: float = 1.0,
        factor_absorption: float = 1.0,
        color=(1.0, 1.0, 1.0),
        opacity_threshold: float = 0.95,
        device: DeviceLike = None,
    ) -> "RenderSettings":
        dev = resolve_device(device)

        def t(v):
            return as_float32(v, dev)

        return cls(
            factor_emission=t(factor_emission),
            factor_reflection=t(factor_reflection),
            factor_absorption=t(factor_absorption),
            color=t(color).reshape(3),
            opacity_threshold=t(opacity_threshold),
        )


class RenderOptions:
    """Static, host-side render constants (hashable)."""

    __slots__ = ("width", "height", "boxmin", "boxmax", "tstep", "gradient_step", "n_steps")

    def __init__(self, width, height, boxmin, boxmax, tstep, gradient_step, n_steps):
        self.width = int(width)
        self.height = int(height)
        self.boxmin = tuple(float(v) for v in boxmin)
        self.boxmax = tuple(float(v) for v in boxmax)
        self.tstep = float(tstep)
        self.gradient_step = tuple(float(v) for v in gradient_step)
        self.n_steps = int(n_steps)

    def _key(self):
        return (self.width, self.height, self.boxmin, self.boxmax, self.tstep,
                self.gradient_step, self.n_steps)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, RenderOptions) and self._key() == other._key()

    def __repr__(self):
        return (f"RenderOptions(width={self.width}, height={self.height}, "
                f"boxmax={self.boxmax}, tstep={self.tstep}, n_steps={self.n_steps})")


def build_render_options(
    emission_extent_xyz: Tuple[int, int, int],
    element_size_um: Tuple[float, float, float],
    width: int,
    height: int,
) -> RenderOptions:
    """Host-side option derivation; float32 arithmetic as in initRender."""
    w, h, d = (np.float32(v) for v in emission_extent_xyz)
    esx, esy, esz = (np.float32(v) for v in element_size_um)

    bx = np.float32(1.0)
    by = np.float32(esy * h) / np.float32(w * esx)
    bz = np.float32(esz * d) / np.float32(w * esx)

    diag_xy = np.sqrt(np.float32(w * w + h * h))
    diag_yz = np.sqrt(np.float32(h * h + d * d))
    diag_xz = np.sqrt(np.float32(w * w + d * d))
    min_diag = np.float32(min(diag_xy, diag_yz, diag_xz))
    tstep = np.float32(1.0) / (np.float32(2.2) * min_diag)

    gradient_step = (1.0 / float(w), 1.0 / float(h), 1.0 / float(d))

    # Upper bound on executed march steps: t runs from tnear >= 0 while
    # t <= tfar, and tfar - tnear is bounded by the box diagonal; +2 covers
    # the unconditional first step and the step that crosses tfar.
    diag_len = 2.0 * float(np.sqrt(bx * bx + by * by + bz * bz))
    n_steps = int(np.ceil(diag_len / float(tstep))) + 2

    return RenderOptions(
        width=width,
        height=height,
        boxmin=(-float(bx), -float(by), -float(bz)),
        boxmax=(float(bx), float(by), float(bz)),
        tstep=float(tstep),
        gradient_step=gradient_step,
        n_steps=n_steps,
    )


@dataclass(frozen=True, eq=False)
class Scene:
    """Everything the march consumes. Optional fields switch features off
    (None => compiled out of the kernel).

    Volume aliasing: absorption=None or reflection=None means "same volume
    as emission" — sampled from the emission grid with no extra fetch.
    """

    emission: Volume
    camera: Camera
    settings: RenderSettings
    absorption: Optional[Volume] = None
    reflection: Optional[Volume] = None
    # precomputed gradient volumes => lookup mode; None => on-the-fly taps
    gradient_x: Optional[Volume] = None
    gradient_y: Optional[Volume] = None
    gradient_z: Optional[Volume] = None
    # illumination LUT (D, H, W) + lights; None/empty => no shading term
    illumination: Optional[torch.Tensor] = None
    light_positions: Optional[torch.Tensor] = None  # (L, 3)
    light_colors: Optional[torch.Tensor] = None  # (L, 3)

    def replace(self, **changes) -> "Scene":
        return dataclasses.replace(self, **changes)

    def to(self, device: DeviceLike) -> "Scene":
        """The scene with every tensor on ``device``: itself where it lies
        there already. The copies stay in autograd's graph."""
        dev = torch.device(device)
        if self.device == dev:
            return self
        s = self.settings
        changes = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for name, value in changes.items():
            if isinstance(value, Volume):
                changes[name] = value.replace(data=value.data.to(dev))
            elif isinstance(value, torch.Tensor):
                changes[name] = value.to(dev)
        changes["camera"] = self.camera.to(dev)
        changes["settings"] = dataclasses.replace(
            s, **{f.name: getattr(s, f.name).to(dev) for f in dataclasses.fields(s)})
        return Scene(**changes)

    @property
    def device(self) -> torch.device:
        return self.emission.data.device

    @property
    def absorption_aliased(self) -> bool:
        return self.absorption is None

    @property
    def reflection_aliased(self) -> bool:
        return self.reflection is None

    @property
    def absorption_volume(self) -> Volume:
        return self.emission if self.absorption is None else self.absorption

    @property
    def reflection_volume(self) -> Volume:
        return self.emission if self.reflection is None else self.reflection

    @property
    def has_lighting(self) -> bool:
        return (
            self.illumination is not None
            and self.light_positions is not None
            and self.light_positions.shape[0] > 0
        )

    @property
    def has_gradient_volumes(self) -> bool:
        return (
            self.gradient_x is not None
            and self.gradient_y is not None
            and self.gradient_z is not None
        )

    def options(self, width: int, height: int) -> RenderOptions:
        return build_render_options(
            self.emission.extent_xyz, self.emission.element_size_um, width, height
        )
