"""Fused forward + replay backward (port of ``volume_renderer_tpu.ops.vjp``).

The backward pass, pixel cotangent -> voxel-grid and transfer-parameter
gradients, with memory that does not grow with the march length.

Forward: the early-exiting march (``ops/forward.py``). Only the image is
saved.

Backward: replay the march front to back. With the under operator

    out = sum_n T_n * s_n,       T_n = prod_{m<n} (1 - alpha_m)

the cotangents of step n are at hand during one forward replay:

    dL/ds_n     = g * T_n
    dL/dalpha_n = -(g . out - g . prefix_n) / (1 - alpha_n)

where prefix_n = sum_{m<=n} T_m * (g . s_m) accumulates as the replay goes
and ``g . out`` comes from the saved image. Per step the adjoint of
``raymarch_core.step_from_taps`` is written out in closed form below; the
tap cotangents are scatter-added into the grids' gradients with the
trilinear weights of the forward fetch (``index_add_``).

``replay_backward`` is that replay as one plain function, vectorised over
the rays. It is the backward of ``render_fused`` and the plain version of
the backward march kernel (``csrc/march_bwd.cu``, ``ops/cuda_grads.py``).

Gradients produced: emission, absorption and reflection grids, the
gradient volumes (lookup mode), the transfer factors, the color and the
light colors. The march geometry (camera, tnear, tfar, positions) and the
early-termination boundary are not differentiated, exactly as autograd of
the masked march does not differentiate them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from volume_renderer_tpu_torch.models.scene import RenderOptions, Scene
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.float3 import F3, div_scalar, dot
from volume_renderer_tpu_torch.ops.forward import _init_rays, render_rows
from volume_renderer_tpu_torch.ops.sampling import sample_trilinear, zslab_corner_indices

Diff = Dict[str, torch.Tensor]

GRID_KEYS = ("emission", "absorption", "reflection", "gradient_x", "gradient_y", "gradient_z")

# the floored angle adjoint bounds 1 / sqrt(1 - ratio^2) at 1e3
ANGLE_FLOOR = 1e-6


def split_scene(scene: Scene) -> Tuple[Diff, Scene]:
    """The differentiable leaves of ``scene`` as a dict, and the scene as
    the template that ``merge_scene`` puts them back into.

    Aliased absorption or reflection (None in the scene) have no leaf of
    their own: their gradients flow into the emission grid.
    """
    s = scene.settings
    diff: Diff = {
        "emission": scene.emission.data,
        "factor_emission": s.factor_emission,
        "factor_absorption": s.factor_absorption,
        "factor_reflection": s.factor_reflection,
        "color": s.color,
    }
    if not scene.absorption_aliased:
        diff["absorption"] = scene.absorption.data
    if not scene.reflection_aliased:
        diff["reflection"] = scene.reflection.data
    if scene.has_lighting:
        diff["light_colors"] = scene.light_colors
    if scene.has_gradient_volumes:
        for key in ("gradient_x", "gradient_y", "gradient_z"):
            diff[key] = getattr(scene, key).data
    return diff, scene


def merge_scene(template: Scene, diff: Diff) -> Scene:
    """``template`` with every leaf of ``diff`` in its place."""
    settings = dataclasses.replace(
        template.settings,
        factor_emission=diff["factor_emission"],
        factor_reflection=diff["factor_reflection"],
        factor_absorption=diff["factor_absorption"],
        color=diff["color"],
    )
    kwargs = {key: getattr(template, key).replace(data=diff[key])
              for key in GRID_KEYS if key in diff}
    if "light_colors" in diff:
        kwargs["light_colors"] = diff["light_colors"]
    return template.replace(settings=settings, **kwargs)


def angle_backward(a: F3, b: F3, d_ang: torch.Tensor, floor: bool) -> Tuple[F3, F3]:
    """Adjoint of ``raymarch_core.angle``: the cotangents of ``a`` and ``b``.

    angle = acos(r), r = (a.b) rsqrt(|a|^2 |b|^2) clamped to [-1, 1];
    dr/da = b / (|a||b|) - r a / |a|^2 (and likewise for b), times
    acos' = -1 / sqrt(1 - r^2); zero where the forward's length guard holds.

    Near the poles acos' grows without bound. ``floor=False`` is what
    autograd of ``angle`` gives: zero where |r| >= 1 - 1e-6. ``floor=True``
    is the convention of the fast gradient entry points and of the kernel:
    1 - r^2 is floored at 1e-6 instead, so the adjoint stays bounded and
    nonzero where near-parallel vectors make the exact derivative mere
    rounding (smooth shells whose normal equals the view direction).
    """
    a2, b2 = dot(a, a), dot(b, b)
    d2 = a2 * b2
    safe_d = d2 > float(core.ANGLE_DENOM_EPS * core.ANGLE_DENOM_EPS)
    inv = torch.where(safe_d, torch.rsqrt(torch.where(safe_d, d2, 1.0)), 0.0)
    r = torch.clamp(torch.where(safe_d, dot(a, b) * inv, 0.0), -1.0, 1.0)
    s2 = 1.0 - r * r
    if floor:
        d_acos = torch.where(safe_d, -torch.rsqrt(torch.clamp_min(s2, ANGLE_FLOOR)), 0.0)
    else:
        safe = safe_d & (torch.abs(r) < 1.0 - core.ANGLE_POLE_EPS)
        d_acos = torch.where(safe, -torch.rsqrt(torch.where(safe, s2, 1.0)), 0.0)
    d_r = d_acos * d_ang
    ra = r * torch.where(safe_d, torch.reciprocal(torch.where(safe_d, a2, 1.0)), 0.0)
    rb = r * torch.where(safe_d, torch.reciprocal(torch.where(safe_d, b2, 1.0)), 0.0)
    d_a = F3(d_r * (b.x * inv - ra * a.x), d_r * (b.y * inv - ra * a.y),
             d_r * (b.z * inv - ra * a.z))
    d_b = F3(d_r * (a.x * inv - rb * b.x), d_r * (a.y * inv - rb * b.y),
             d_r * (a.z * inv - rb * b.z))
    return d_a, d_b


def scatter_trilinear(flat_grad: torch.Tensor, shape_dhw, coords: F3, d_val: torch.Tensor,
                      z_offset: int = 0, full_d: Optional[int] = None) -> None:
    """Adds ``d_val`` times the 8 trilinear weights into ``flat_grad`` at the
    8 clamped corners: the exact adjoint of ``sample_trilinear``. A sample
    clamped at an edge sends both corners' weights to the one edge voxel.

    With ``full_d`` the grid is a z-slab (rows from ``z_offset``) of a volume
    ``full_d`` deep and ``coords`` are global: the adjoint of
    ``sample_trilinear_zslab``."""
    full_d = shape_dhw[0] if full_d is None else full_d
    idx, fx, fy, fz = zslab_corner_indices(tuple(shape_dhw), z_offset, full_d, coords)
    wx, wy, wz = (1.0 - fx, fx), (1.0 - fy, fy), (1.0 - fz, fz)
    weights = [gx * gy * gz for gz in wz for gy in wy for gx in wx]
    flat_grad.index_add_(0, torch.cat(idx),
                         torch.cat([w * d_val for w in weights]).to(flat_grad.dtype))


class _LightTerms(NamedTuple):
    """What the adjoint of one light's shading term needs from its forward."""

    light_out: F3
    dot_out: torch.Tensor   # light_out . normal
    out_proj: F3
    lut: torch.Tensor       # the LUT value and its coordinate derivatives
    d_lut: F3


def _accumulate(acc: Dict, key, value: torch.Tensor, dtype: torch.dtype) -> None:
    value = value.to(dtype)
    acc[key] = value if key not in acc else acc[key] + value


def _whole_volume(data: torch.Tensor) -> Tuple[int, int]:
    return 0, data.shape[0]


class StepReplay:
    """The adjoint of one march step and the sums it feeds: the part of the
    replay that does not know how the rays advance.

    ``step`` takes the rays' positions, which of them composite a sample
    there, and the opacity and prefix = sum T (g . s) they carry; it adds the
    sample's cotangents to the gradient grids and the per-ray parameter sums
    and returns the sample's alpha and the new prefix. ``replay_backward``
    drives it along whole rays; the z-brick replay
    (``ops/brick_march.py``) along the part of each ray that one brick owns,
    with ``samplers`` over the brick's halo-padded grids and
    ``slab_geometry`` (grid tensor -> (z_offset, full depth)) saying where
    each grid lies in its volume.
    """

    def __init__(self, scene: Scene, consts, origin: F3, g: torch.Tensor, image: torch.Tensor,
                 samplers=None, slab_geometry=_whole_volume, angle_floor: bool = False,
                 accum_dtype: torch.dtype = torch.float32):
        self.scene, self.consts, self.origin = scene, consts, origin
        self.samplers = core.make_samplers(scene) if samplers is None else samplers
        self.params = core.params_of(scene, consts)
        self.angle_floor, self.accum_dtype = angle_floor, accum_dtype
        n_rays = g.numel() // 3
        self.g3 = F3(*g.reshape(n_rays, 3).to(torch.float32).unbind(-1))
        self.total_dot = dot(self.g3, F3(*image.reshape(n_rays, 3).unbind(-1)))

        lit, lookup = scene.has_lighting, scene.has_gradient_volumes
        keys = ["emission"]
        if not scene.absorption_aliased:
            keys.append("absorption")
        if lit and not scene.reflection_aliased:
            keys.append("reflection")
        if lookup:
            keys += ["gradient_x", "gradient_y", "gradient_z"]
        self.grids, self.geometry = {}, {}
        for key in keys:
            data = getattr(scene, key).data
            self.grids[key] = torch.zeros(data.numel(), dtype=accum_dtype, device=data.device)
            self.geometry[key] = (tuple(data.shape), *slab_geometry(data))
        # the parameters' cotangents accumulate per ray and are summed once
        self.acc: Dict = {}

    def _scatter(self, key: str, coords: F3, d_val: torch.Tensor) -> None:
        shape, z_offset, full_d = self.geometry[key]
        scatter_trilinear(self.grids[key], shape, coords, d_val, z_offset, full_d)

    def step(self, pos: F3, active: torch.Tensor, sum_w: torch.Tensor,
             prefix_dot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scene, consts, params, samplers = self.scene, self.consts, self.params, self.samplers
        origin, g3, acc, accum_dtype = self.origin, self.g3, self.acc, self.accum_dtype
        lit, lookup = scene.has_lighting, scene.has_gradient_volumes
        ts = consts.tstep
        fe, fa, fr = params.factor_emission, params.factor_absorption, params.factor_reflection
        color = params.color

        sample_pos = core.to_sample_coords(pos, consts)
        taps = core.gather_taps(scene, consts, pos, samplers)

        # ---- the step's forward values, as step_from_taps has them ----
        emission = fe * taps.em
        absorption = fa * taps.ab
        transmit = torch.exp(-absorption * ts)
        alpha = 1.0 - transmit
        illuminated = F3(emission * ts * color.x, emission * ts * color.y,
                         emission * ts * color.z)
        lights: List[_LightTerms] = []
        if lit:
            grad = core.tap_gradient(scene, taps)
            inv_len = core.normal_inv_len(grad)
            normal = grad * (-inv_len)
            reflection = fr * taps.re
            light_in = origin - pos
            dot_in = dot(light_in, normal)
            in_proj = light_in - normal * dot_in
            for lp, lc in zip(scene.light_positions, params.light_colors):
                light_out = F3(lp[0] - pos.x, lp[1] - pos.y, lp[2] - pos.z)
                a = div_scalar(core.angle(normal, light_in), float(core.PI))
                b = div_scalar(core.angle(normal, light_out), float(core.PI))
                dot_out = dot(light_out, normal)
                out_proj = light_out - normal * dot_out
                gam = div_scalar(core.angle(in_proj, out_proj), float(core.PI))
                lut, dl_a, dl_b, dl_g = sample_trilinear(scene.illumination, F3(a, b, gam),
                                                         with_grad=True)
                lights.append(_LightTerms(light_out, dot_out, out_proj, lut,
                                          F3(dl_a, dl_b, dl_g)))
                contrib = reflection * lut
                illuminated = illuminated + F3(contrib * lc[0] * color.x,
                                               contrib * lc[1] * color.y,
                                               contrib * lc[2] * color.z)
        s_rgb = illuminated * alpha

        # ---- cotangents of (s, alpha) from the under operator ----
        tr = 1.0 - sum_w
        prefix_dot = prefix_dot + torch.where(active, tr * dot(g3, s_rgb), 0.0)
        d_s = F3(*(torch.where(active, c * tr, 0.0) for c in g3))
        one_m_a = 1.0 - alpha
        open_ = one_m_a > 0.0
        d_alpha = torch.where(active & open_,
                              -(self.total_dot - prefix_dot) / torch.where(open_, one_m_a, 1.0),
                              0.0)

        # ---- adjoint of step_from_taps ----
        d_illum = d_s * alpha
        d_absorption = (d_alpha + dot(d_s, illuminated)) * (transmit * ts)
        d_emission = dot(d_illum, color) * ts
        _accumulate(acc, "factor_absorption", d_absorption * taps.ab, accum_dtype)
        _accumulate(acc, "factor_emission", d_emission * taps.em, accum_dtype)
        d_color = d_illum * (emission * ts)
        d_em, d_ab = d_emission * fe, d_absorption * fa
        d_re = None
        d_grad = None
        if lit:
            d_refl = torch.zeros_like(alpha)
            d_n = F3(d_refl, d_refl, d_refl)
            for li, (terms, lc) in enumerate(zip(lights, params.light_colors)):
                contrib = reflection * terms.lut
                lit_c = F3(d_illum.x * contrib, d_illum.y * contrib, d_illum.z * contrib)
                for c in range(3):
                    _accumulate(acc, ("light_colors", li, c), lit_c[c] * color[c], accum_dtype)
                d_color = d_color + F3(lit_c.x * lc[0], lit_c.y * lc[1], lit_c.z * lc[2])
                d_contrib = (d_illum.x * lc[0] * color.x + d_illum.y * lc[1] * color.y
                             + d_illum.z * lc[2] * color.z)
                d_refl = d_refl + d_contrib * terms.lut
                # d lut -> d angles -> d normal; the tangent-plane
                # projections pull the third angle back to the normal too
                d_lut = d_contrib * reflection
                d_a, _ = angle_backward(normal, light_in,
                                        div_scalar(d_lut * terms.d_lut.x, float(core.PI)),
                                        self.angle_floor)
                d_b, _ = angle_backward(normal, terms.light_out,
                                        div_scalar(d_lut * terms.d_lut.y, float(core.PI)),
                                        self.angle_floor)
                u, v = angle_backward(in_proj, terms.out_proj,
                                      div_scalar(d_lut * terms.d_lut.z, float(core.PI)),
                                      self.angle_floor)
                # in_proj = light_in - (light_in . n) n  =>
                # d n -= (u . n) light_in + (light_in . n) u, likewise out
                d_n = (d_n + d_a + d_b - light_in * dot(u, normal) - u * dot_in
                       - terms.light_out * dot(v, normal) - v * terms.dot_out)
            _accumulate(acc, "factor_reflection", d_refl * taps.re, accum_dtype)
            d_re = d_refl * fr
            # n = -grad / |grad|
            d_grad = d_n * (-inv_len) + grad * (dot(d_n, grad) * inv_len * inv_len * inv_len)
        for c in range(3):
            _accumulate(acc, ("color", c), d_color[c], accum_dtype)

        # ---- scatter the tap cotangents; aliased roles add into the
        # emission grid at the emission corners ----
        d_at_em = d_em
        if scene.absorption_aliased:
            d_at_em = d_at_em + d_ab
        else:
            self._scatter("absorption", sample_pos, d_ab)
        if lit:
            if scene.reflection_aliased:
                d_at_em = d_at_em + d_re
            else:
                self._scatter("reflection", sample_pos, d_re)
            if lookup:
                for key, d_tap in zip(("gradient_x", "gradient_y", "gradient_z"), d_grad):
                    self._scatter(key, sample_pos, d_tap)
            else:
                d_taps = (d_grad.x * 0.5, d_grad.x * -0.5, d_grad.y * 0.5, d_grad.y * -0.5,
                          d_grad.z * 0.5, d_grad.z * -0.5)
                for p, d_tap in zip(core.otf_tap_positions(pos, consts), d_taps):
                    self._scatter("emission", p, d_tap)
        self._scatter("emission", sample_pos, d_at_em)
        return alpha, prefix_dot

    def result(self) -> Diff:
        """The gradients of every leaf of ``split_scene(scene)``; the grids
        in the shape of the scene's own."""
        scene, acc, accum_dtype = self.scene, self.acc, self.accum_dtype

        def total(key):
            return (acc[key].sum() if key in acc
                    else torch.zeros((), dtype=accum_dtype, device=scene.device))

        out: Diff = {key: grid.reshape(self.geometry[key][0])
                     for key, grid in self.grids.items()}
        if not scene.reflection_aliased and "reflection" not in out:
            out["reflection"] = torch.zeros_like(scene.reflection.data, dtype=accum_dtype)
        for key in ("factor_emission", "factor_absorption", "factor_reflection"):
            out[key] = total(key)
        out["color"] = torch.stack([total(("color", c)) for c in range(3)])
        if scene.has_lighting:
            n_lights = scene.light_positions.shape[0]
            out["light_colors"] = torch.stack([
                torch.stack([total(("light_colors", li, c)) for c in range(3)])
                for li in range(n_lights)])
        return out


def replay_backward(
    scene: Scene,
    opts: RenderOptions,
    g: torch.Tensor,
    image: torch.Tensor,
    camera_x_offset: float = 0.0,
    y_offset: int = 0,
    n_rows: Optional[int] = None,
    early_exit: bool = True,
    angle_floor: bool = False,
    accum_dtype: torch.dtype = torch.float32,
) -> Diff:
    """The gradients of every leaf of ``split_scene(scene)`` for the pixel
    cotangent ``g`` (n_rows, W, 3), given the rendered band ``image``.

    ``image`` must be what the forward march gave for this scene, band and
    ``camera_x_offset``. ``early_exit=False`` replays the fixed trip count
    ``opts.n_steps`` (same values). ``angle_floor`` picks the angle adjoint
    (see ``angle_backward``). An unlit scene with a reflection volume gets
    a zero reflection gradient.

    Every term is computed in float32; ``accum_dtype`` is the type they are
    summed in, and of the result. With float64 the sums no longer depend on
    their order: the yardstick for the kernel's atomic adds, which land in
    no fixed order, and for ``index_add_``.
    """
    n_rows = opts.height if n_rows is None else int(n_rows)
    if tuple(g.shape) != (n_rows, opts.width, 3) or tuple(image.shape) != tuple(g.shape):
        raise ValueError(f"g and image must be ({n_rows}, {opts.width}, 3), got "
                         f"{tuple(g.shape)} and {tuple(image.shape)}")
    with torch.no_grad():
        consts, origin, pos, step, t, tfar, active = _init_rays(
            scene, opts, camera_x_offset, int(y_offset), n_rows)
        replay = StepReplay(scene, consts, origin, g, image, angle_floor=angle_floor,
                            accum_dtype=accum_dtype)
        sum_w = torch.zeros_like(t)
        prefix_dot = torch.zeros_like(t)

        i = 0
        while i < opts.n_steps and (not early_exit or bool(active.any())):
            alpha, prefix_dot = replay.step(pos, active, sum_w, prefix_dot)

            # ---- advance exactly like the forward march ----
            sum_w = torch.where(active, (1.0 - sum_w) * alpha + sum_w, sum_w)
            t = t + consts.tstep
            active = active & (sum_w <= consts.opacity_threshold) & (t <= tfar)
            pos = pos + step
            i += 1
        return replay.result()


class _RenderFused(torch.autograd.Function):
    """The early-exit march forward, the replay backward; saves the image."""

    @staticmethod
    def forward(ctx, template, opts, cam_off, y_offset, n_rows, early_exit, keys, *leaves):
        scene = merge_scene(template, dict(zip(keys, leaves)))
        out = render_rows(scene, opts, cam_off, y_offset, n_rows, differentiable=not early_exit)
        ctx.save_for_backward(out, *leaves)
        ctx.static = (template, opts, cam_off, y_offset, n_rows, early_exit, keys)
        return out

    @staticmethod
    def backward(ctx, g):
        template, opts, cam_off, y_offset, n_rows, early_exit, keys = ctx.static
        out, *leaves = ctx.saved_tensors
        scene = merge_scene(template, dict(zip(keys, leaves)))
        grads = replay_backward(scene, opts, g, out, cam_off, y_offset, n_rows,
                                early_exit=early_exit)
        return (None,) * 7 + tuple(
            grads[key] if need else None
            for key, need in zip(keys, ctx.needs_input_grad[7:]))


def render_fused(
    scene: Scene,
    opts: RenderOptions,
    camera_x_offset: float = 0.0,
    y_offset: int = 0,
    n_rows: Optional[int] = None,
    early_exit: bool = True,
) -> torch.Tensor:
    """Differentiable render of a band, (n_rows, W, 3), on the scene's
    device: the early-exit march forward and the replay backward, in plain
    PyTorch. Gradients reach every leaf of ``split_scene(scene)`` that
    requires grad. The drop-in for ``render_rows`` under ``torch.autograd``,
    for custom losses; for the sum-of-squares loss on a CUDA scene the
    kernels behind ``ops.cuda_grads.voxel_grads_fast`` are the fast way.

    ``early_exit=False`` runs the fixed trip count ``opts.n_steps`` in both
    directions, for callers whose replicas must do equal work.
    """
    diff, template = split_scene(scene)
    keys = tuple(diff)
    return _RenderFused.apply(template, opts, float(camera_x_offset), int(y_offset),
                              opts.height if n_rows is None else int(n_rows),
                              bool(early_exit), keys, *(diff[k] for k in keys))
