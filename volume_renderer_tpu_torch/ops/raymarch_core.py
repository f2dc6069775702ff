"""Per-step ray-march math (port of ``volume_renderer_tpu.ops.raymarch_core``,
forward only).

Per step at world position ``pos`` (reference volumeRender_kernel.cu:435-493):

    pos_sample   = (pos - boxmin) * boxscale          # normalized [0,1]
    emission     = factor_emission   * tex(em, pos_sample)
    absorption   = factor_absorption * tex(ab, pos_sample)
    alpha        = 1 - exp(-absorption * tstep)
    colored      = emission * tstep * color
    illuminated  = colored + shade(...)
    shaded       = (illuminated * alpha, alpha)        # premultiplied
    sum          = (1 - sum.w) * shaded + sum          # front-to-back under

shade(), per light source (volumeRender_kernel.cu:308-353):

    n      = -normalize(gradient)          # on-the-fly central differences
                                           # or precomputed dx/dy/dz lookup
    lightOut = lightPos - pos ; lightIn = eyeOrigin - pos
    alpha  = angle(n, lightIn)  / pi
    beta   = angle(n, lightOut) / pi
    gamma  = angle(proj_t(lightIn), proj_t(lightOut)) / pi
    result += factor_reflection * tex(re, pos_sample)
              * tex(lut, (alpha, beta, gamma)) * lightColor * color

Gradients with |g|^2 <= GRAD_EPS2 clamp to the zero normal, and ``angle``
takes pi/2 for near-zero-length inputs: deterministic where the reference
shades with rounding noise. ``csrc/march_fwd.cu`` repeats this arithmetic
per ray in the same order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops.float3 import F3, div_scalar, dot
from volume_renderer_tpu_torch.ops.sampling import sample_trilinear


class Samplers(NamedTuple):
    """Role -> trilinear fetch callables (normalized coords -> value);
    None when the role is compiled out."""

    em: object
    ab: object
    re: object = None
    gx: object = None
    gy: object = None
    gz: object = None
    lut: object = None


def make_samplers(scene: Scene) -> Samplers:
    """Samplers over the full volume tensors (with aliasing)."""
    def sampler(volume):
        return lambda p: sample_trilinear(volume, p)

    em = sampler(scene.emission.data)
    ab = em if scene.absorption_aliased else sampler(scene.absorption.data)
    re = gx = gy = gz = lut = None
    if scene.has_lighting:
        re = em if scene.reflection_aliased else sampler(scene.reflection.data)
        lut = sampler(scene.illumination)
        if scene.has_gradient_volumes:
            gx = sampler(scene.gradient_x.data)
            gy = sampler(scene.gradient_y.data)
            gz = sampler(scene.gradient_z.data)
    return Samplers(em=em, ab=ab, re=re, gx=gx, gy=gy, gz=gz, lut=lut)


PI = np.float32(3.14159265358979323846)

# Gradients with squared norm below this are rounding noise of float32
# trilinear differences (~(1e-7)^2 = 1e-14); treat as zero normal.
GRAD_EPS2 = np.float32(1e-12)

# angle() denominators (product of the two vector lengths) below this take
# the guarded branch: the angle is geometrically ill-defined.
ANGLE_DENOM_EPS = np.float32(1e-12)


class MarchConsts(NamedTuple):
    """Per-render constants derived from Scene + RenderOptions. Host values
    are python floats holding float32 numbers; settings stay tensors."""

    boxmin: Tuple[float, float, float]
    boxmax: Tuple[float, float, float]
    boxscale: Tuple[float, float, float]
    tstep: float
    opacity_threshold: torch.Tensor
    factor_emission: torch.Tensor
    factor_absorption: torch.Tensor
    factor_reflection: torch.Tensor
    color: F3
    gradient_step: Tuple[float, float, float]


def _f32(values) -> Tuple[float, ...]:
    return tuple(float(np.float32(v)) for v in values)


def make_consts(scene: Scene, opts: RenderOptions) -> MarchConsts:
    s = scene.settings
    return MarchConsts(
        boxmin=_f32(opts.boxmin),
        boxmax=_f32(opts.boxmax),
        boxscale=_f32(1.0 / (opts.boxmax[i] - opts.boxmin[i]) for i in range(3)),
        tstep=float(np.float32(opts.tstep)),
        opacity_threshold=s.opacity_threshold,
        factor_emission=s.factor_emission,
        factor_absorption=s.factor_absorption,
        factor_reflection=s.factor_reflection,
        color=F3(s.color[0], s.color[1], s.color[2]),
        gradient_step=_f32(opts.gradient_step),
    )


def angle(a: F3, b: F3) -> torch.Tensor:
    """acos of the normalized dot product, guarded against zero-length
    inputs (angle pi/2) and rounding outside [-1, 1]."""
    d2 = dot(a, a) * dot(b, b)
    safe_d = d2 > float(ANGLE_DENOM_EPS * ANGLE_DENOM_EPS)
    ratio = torch.where(
        safe_d, dot(a, b) * torch.rsqrt(torch.where(safe_d, d2, 1.0)), 0.0
    )
    return torch.arccos(torch.clamp(ratio, -1.0, 1.0))


def to_sample_coords(pos: F3, consts: MarchConsts) -> F3:
    bmin, bs = consts.boxmin, consts.boxscale
    return F3((pos.x - bmin[0]) * bs[0], (pos.y - bmin[1]) * bs[1], (pos.z - bmin[2]) * bs[2])


class Taps(NamedTuple):
    """Raw texture values fetched at one march step (before any factor)."""

    em: torch.Tensor
    ab: torch.Tensor
    re: Optional[torch.Tensor]  # lighting only
    grad_taps: Optional[Tuple[torch.Tensor, ...]]
    # lighting only: on-the-fly mode -> 6 emission taps (xp, xm, yp, ym,
    # zp, zm); lookup mode -> 3 gradient-volume taps (gx, gy, gz)


def otf_tap_positions(pos: F3, consts: MarchConsts) -> Tuple[F3, ...]:
    """Sample coords of the 6 central-difference taps (xp, xm, yp, ym, zp, zm),
    one voxel (gradient_step) away in WORLD units."""
    gs = consts.gradient_step
    out = []
    for axis in range(3):
        for sign in (1.0, -1.0):
            comps = list(pos)
            comps[axis] = comps[axis] + sign * gs[axis]
            out.append(to_sample_coords(F3(*comps), consts))
    return tuple(out)


def gather_taps(scene: Scene, consts: MarchConsts, pos: F3, samplers: Samplers) -> Taps:
    """All texture fetches of one march step; aliased roles reuse the
    emission fetch."""
    sample_pos = to_sample_coords(pos, consts)
    em = samplers.em(sample_pos)
    ab = em if samplers.ab is samplers.em else samplers.ab(sample_pos)
    re = None
    grad_taps = None
    if scene.has_lighting:
        re = em if samplers.re is samplers.em else samplers.re(sample_pos)
        if scene.has_gradient_volumes:
            grad_taps = (samplers.gx(sample_pos), samplers.gy(sample_pos), samplers.gz(sample_pos))
        else:
            grad_taps = tuple(samplers.em(p) for p in otf_tap_positions(pos, consts))
    return Taps(em=em, ab=ab, re=re, grad_taps=grad_taps)


def shade_from_taps(scene: Scene, consts: MarchConsts, taps: Taps, pos: F3,
                    eye_origin: F3, samplers: Samplers) -> Optional[F3]:
    """Illumination sum over all light sources; None if lighting is off."""
    if not scene.has_lighting:
        return None

    if scene.has_gradient_volumes:
        grad = F3(*taps.grad_taps)
    else:
        xp, xm, yp, ym, zp, zm = taps.grad_taps
        grad = F3((xp - xm) * 0.5, (yp - ym) * 0.5, (zp - zm) * 0.5)

    # negative normalized gradient approximates the surface normal; noise-
    # level gradients clamp to the zero normal
    g2 = dot(grad, grad)
    keep = g2 > float(GRAD_EPS2)
    inv_len = torch.where(keep, torch.rsqrt(torch.where(keep, g2, 1.0)), 0.0)
    surface_normal = grad * (-inv_len)

    reflection = consts.factor_reflection * taps.re
    color = consts.color

    result = None
    for lp, lc in zip(scene.light_positions, scene.light_colors):
        light_out = F3(lp[0] - pos.x, lp[1] - pos.y, lp[2] - pos.z)
        light_in = eye_origin - pos

        a = div_scalar(angle(surface_normal, light_in), float(PI))
        b = div_scalar(angle(surface_normal, light_out), float(PI))

        light_out_proj = light_out - surface_normal * dot(light_out, surface_normal)
        light_in_proj = light_in - surface_normal * dot(light_in, surface_normal)
        g = div_scalar(angle(light_in_proj, light_out_proj), float(PI))

        contrib = reflection * samplers.lut(F3(a, b, g))
        term = F3(contrib * lc[0] * color.x, contrib * lc[1] * color.y, contrib * lc[2] * color.z)
        result = term if result is None else result + term
    return result


def march_step(scene: Scene, consts: MarchConsts, pos: F3, eye_origin: F3,
               samplers: Samplers) -> Tuple[F3, torch.Tensor]:
    """One march step: returns (premultiplied rgb, alpha) at ``pos``."""
    taps = gather_taps(scene, consts, pos, samplers)
    emission = consts.factor_emission * taps.em
    absorption = consts.factor_absorption * taps.ab

    alpha = 1.0 - torch.exp(-absorption * consts.tstep)

    ds = consts.tstep
    color = consts.color
    illuminated = F3(emission * ds * color.x, emission * ds * color.y, emission * ds * color.z)
    illumination = shade_from_taps(scene, consts, taps, pos, eye_origin, samplers)
    if illumination is not None:
        illuminated = illuminated + illumination

    return illuminated * alpha, alpha


def composite_under(sum_rgb: F3, sum_w: torch.Tensor, shaded_rgb: F3,
                    alpha: torch.Tensor) -> Tuple[F3, torch.Tensor]:
    """Front-to-back under operator: sum = (1 - sum.w) * shaded + sum."""
    t = 1.0 - sum_w
    new_rgb = F3(t * shaded_rgb.x + sum_rgb.x, t * shaded_rgb.y + sum_rgb.y,
                 t * shaded_rgb.z + sum_rgb.z)
    return new_rgb, t * alpha + sum_w
