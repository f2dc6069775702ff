"""The plain reference march: front-to-back emission, absorption and
Henyey-Greenstein shading over trilinear volumes, in plain PyTorch.

It imports nothing of the program under test. It follows the upstream
renderer's semantics (the CUDA kernel ``volumeRender_kernel.cu`` of
raphiniert-com/volume_renderer, and its ``initRender`` for the host
constants):

- rays: ``u = x / W * 2 - 1``, ``v = y / H * 2 r - r`` with ``r = H / W``;
  origin ``offset * xVec - distance * zVec``; direction
  ``normalize(u * normalize(xVec) + v * yVec + focal * zVec)``; the columns
  of the rotation are ``xVec``, ``yVec``, ``zVec``;
- the render box ``boxmax = (1, h esy / (w esx), d esz / (w esx))``,
  ``boxmin = -boxmax``, a slab intersection, ``tnear`` clamped at 0;
- step ``tstep = 1 / (2.2 min(face diagonals))``, gradient taps
  ``(1/w, 1/h, 1/d)`` away in world units (half a voxel);
- sample ``k`` at ``pos0 + k * step``, composited while the opacity stays
  at or below the threshold and ``t`` at or below ``tfar``;
- texture fetch: normalized coordinates, ``u = c N - 0.5``, clamp
  addressing, blended x, then y, then z;
- shading per light: the normal ``-g / |g|`` (zero where ``|g|^2 <= 1e-12``),
  the three angles over pi, the LUT at ``(alpha, beta, gamma)``, times the
  reflection, the light's colour and the colour.

Unlike the program it computes every sample of a ray at once (positions by
multiplication, not accumulation; the composite by a cumulative product),
in whatever ``dtype`` it is given: float64 for the reference, bfloat16 for
the control. Rays go in chunks of about ``chunk_samples`` samples, longest
first, so that a full frame fits; ``loss_and_grads`` differentiates each
chunk's loss with ``torch.autograd`` before the next, the volumes'
gradients going into one buffer each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

GRAD_EPS2 = 1e-12           # a squared gradient at or below it is the zero normal
ANGLE_DENOM_EPS2 = 1e-24    # angle(): |a|^2 |b|^2 at or below it gives pi / 2
ANGLE_POLE_EPS = 1e-6       # angle(): its gradient is zero this close to the poles


@dataclass(frozen=True)
class RefScene:
    """Everything a reference render reads, as tensors of one dtype on one
    device. Volumes are (D, H, W); ``gradients`` is (D, H, W, 3) or None
    (then the normal is from six emission taps); ``illumination`` the LUT."""

    emission: torch.Tensor
    absorption: torch.Tensor
    reflection: torch.Tensor
    gradients: Optional[torch.Tensor]
    illumination: torch.Tensor
    light_positions: torch.Tensor   # (L, 3)
    light_colors: torch.Tensor      # (L, 3)
    factor_emission: torch.Tensor
    factor_absorption: torch.Tensor
    factor_reflection: torch.Tensor
    color: torch.Tensor             # (3,)
    opacity_threshold: float
    element_size_um: Tuple[float, float, float]
    rotation: torch.Tensor          # (3, 3)
    focal_length: float
    distance_to_object: float
    width: int
    height: int
    camera_x_offset: float = 0.0
    # volume name -> flat buffer that its fetches' gradients go to
    sinks: Optional[Dict[str, torch.Tensor]] = None

    def sink(self, name: str) -> Optional[torch.Tensor]:
        return None if self.sinks is None else self.sinks.get(name)

    def replace(self, **changes) -> "RefScene":
        return replace(self, **changes)


# ---- camera ------------------------------------------------------------

def euler(alpha_deg: float, beta_deg: float, gamma_deg: float) -> np.ndarray:
    """``Rx(alpha) @ Ry(beta) @ Rz(gamma)`` in float64."""
    a, b, g = (math.radians(v) for v in (alpha_deg, beta_deg, gamma_deg))
    rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
    rz = np.array([[math.cos(g), -math.sin(g), 0], [math.sin(g), math.cos(g), 0], [0, 0, 1]])
    return rx @ ry @ rz


def pose(rotations: Sequence[Sequence[float]]) -> np.ndarray:
    """The rotation after the camera's ``rotate`` calls, in order, from the
    identity: each post-multiplies ``Rx Ry Rz``."""
    m = np.eye(3)
    for r in rotations:
        m = m @ euler(*r)
    return m


# ---- host constants ----------------------------------------------------

@dataclass(frozen=True)
class Consts:
    boxmin: Tuple[float, float, float]
    boxmax: Tuple[float, float, float]
    tstep: float
    gradient_step: Tuple[float, float, float]
    n_steps: int


def consts(shape_dhw: Tuple[int, int, int], element_size_um) -> Consts:
    """The host constants, in float32 as ``initRender`` computes them."""
    d, h, w = (np.float32(v) for v in shape_dhw)
    esx, esy, esz = (np.float32(v) for v in element_size_um)
    by = np.float32(esy * h) / np.float32(w * esx)
    bz = np.float32(esz * d) / np.float32(w * esx)
    diag = min(np.sqrt(np.float32(w * w + h * h)), np.sqrt(np.float32(h * h + d * d)),
               np.sqrt(np.float32(w * w + d * d)))
    tstep = np.float32(1.0) / (np.float32(2.2) * np.float32(diag))
    box = (1.0, float(by), float(bz))
    n_steps = int(np.ceil(2.0 * math.sqrt(sum(b * b for b in box)) / float(tstep))) + 2
    return Consts(boxmin=tuple(-b for b in box), boxmax=box, tstep=float(tstep),
                  gradient_step=(1.0 / float(w), 1.0 / float(h), 1.0 / float(d)),
                  n_steps=n_steps)


# ---- rays ----------------------------------------------------------------

@dataclass
class Rays:
    pixels: torch.Tensor    # (N,) flat pixel index y * W + x
    origin: torch.Tensor    # (3,)
    pos0: torch.Tensor      # (N, 3)
    step: torch.Tensor      # (N, 3)
    n_geo: torch.Tensor     # (N,) int64: samples before t leaves the box


def rays(scene: RefScene, c: Consts, pixels: torch.Tensor, dtype) -> Rays:
    dev = pixels.device
    w, h = scene.width, scene.height
    px = (pixels % w).to(dtype)
    py = (pixels // w).to(dtype)
    ratio = float(np.float32(h) / np.float32(w))
    u = px / w * 2.0 - 1.0
    v = py / h * 2.0 * ratio - ratio
    rot = scene.rotation.to(dev, dtype)
    xv, yv, zv = rot[:, 0], rot[:, 1], rot[:, 2]
    origin = scene.camera_x_offset * xv - scene.distance_to_object * zv
    xn = xv / torch.linalg.vector_norm(xv)
    d = u[:, None] * xn + v[:, None] * yv + scene.focal_length * zv
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    bmin = torch.tensor(c.boxmin, dtype=dtype, device=dev)
    bmax = torch.tensor(c.boxmax, dtype=dtype, device=dev)
    t1 = (bmin - origin) / d
    t2 = (bmax - origin) / d
    tmin = torch.minimum(t1, t2).amax(dim=1)
    tmax = torch.maximum(t1, t2).amin(dim=1)
    hit = tmin <= tmax
    tnear = torch.clamp_min(tmin, 0.0)
    pos0 = origin + d * tnear[:, None]
    span = torch.floor(((tmax - tnear) / c.tstep).to(torch.float64))
    n_geo = torch.where(hit, 1 + torch.clamp_min(span, 0).to(torch.int64), 0)
    n_geo = torch.clamp_max(n_geo, c.n_steps)
    return Rays(pixels=pixels, origin=origin, pos0=pos0, step=d * c.tstep, n_geo=n_geo)


# ---- texture fetch ---------------------------------------------------------

class _Gather(torch.autograd.Function):
    """``flat[idx]`` whose backward adds the cotangents into ``sink``, a
    buffer the caller keeps for the whole image, instead of a fresh
    gradient of the volume's size for each chunk."""

    @staticmethod
    def forward(ctx, flat, idx, sink):
        ctx.save_for_backward(idx)
        ctx.sink = sink
        return flat.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        ctx.sink.index_add_(0, idx, g.to(ctx.sink.dtype))
        return None, None, None


def fetch(volume: torch.Tensor, coords: torch.Tensor,
          sink: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Trilinear fetch of ``volume`` ((D, H, W), or (D, H, W, C) for C
    channels at the same corners) at normalized ``coords`` (..., 3) in (x,
    y, z) order; clamp addressing. Returns (...) or (..., C). ``sink``
    (the volume's size, flat): where the fetch's gradient goes."""
    d, h, w = volume.shape[:3]
    chan = volume.shape[3:]
    flat = volume.reshape(d * h * w, *chan)
    size = torch.tensor((w, h, d), dtype=coords.dtype, device=coords.device)
    u = coords * size - 0.5
    f = torch.floor(u)
    frac = u - f
    hi = torch.tensor((w - 1, h - 1, d - 1), device=coords.device)
    i0 = torch.minimum(torch.clamp_min(f.to(torch.int64), 0), hi)
    i1 = torch.minimum(torch.clamp_min(f.to(torch.int64) + 1, 0), hi)
    x = (i0[..., 0], i1[..., 0])
    y = (i0[..., 1] * w, i1[..., 1] * w)
    z = (i0[..., 2] * (w * h), i1[..., 2] * (w * h))
    idx = torch.stack([x[a] + y[b] + z[c] for c in (0, 1) for b in (0, 1) for a in (0, 1)])
    if sink is not None and torch.is_grad_enabled():
        corners = _Gather.apply(flat, idx.reshape(-1), sink)
    else:
        corners = flat.index_select(0, idx.reshape(-1))
    corners = corners.reshape(*idx.shape, *chan)
    fx, fy, fz = (frac[..., i] for i in range(3))
    if chan:
        fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]
    c000, c100, c010, c110, c001, c101, c011, c111 = corners.unbind(0)
    c00 = c000 + fx * (c100 - c000)
    c10 = c010 + fx * (c110 - c010)
    c01 = c001 + fx * (c101 - c001)
    c11 = c011 + fx * (c111 - c011)
    c0 = c00 + fy * (c10 - c00)
    c1 = c01 + fy * (c11 - c01)
    return c0 + fz * (c1 - c0)


# ---- shading -------------------------------------------------------------

def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle between ``a`` and ``b`` (..., 3): pi / 2 where either is of
    about zero length; acos's gradient is left out at the poles."""
    d2 = _dot(a, a) * _dot(b, b)
    safe_d = d2 > ANGLE_DENOM_EPS2
    ratio = torch.where(safe_d, _dot(a, b) * torch.rsqrt(torch.where(safe_d, d2, 1.0)), 0.0)
    ratio = torch.clamp(ratio, -1.0, 1.0)
    if not ratio.requires_grad:
        return torch.arccos(ratio)
    safe = torch.abs(ratio) < 1.0 - ANGLE_POLE_EPS
    return torch.where(safe, torch.arccos(torch.where(safe, ratio, 0.0)),
                       torch.arccos(ratio.detach()))


def _shade(scene: RefScene, c: Consts, pos: torch.Tensor, sc: torch.Tensor,
           origin: torch.Tensor) -> torch.Tensor:
    """The illumination of every sample, (..., 3)."""
    if scene.gradients is not None:
        grad = fetch(scene.gradients, sc)
    else:
        gs = c.gradient_step
        scale = 1.0 / (torch.tensor(c.boxmax, dtype=pos.dtype, device=pos.device)
                       - torch.tensor(c.boxmin, dtype=pos.dtype, device=pos.device))
        offs = torch.zeros((6, 3), dtype=pos.dtype, device=pos.device)
        for axis in range(3):
            offs[2 * axis, axis] = gs[axis] * scale[axis]
            offs[2 * axis + 1, axis] = -gs[axis] * scale[axis]
        taps = fetch(scene.emission, sc[None] + offs.reshape(6, *([1] * (sc.dim() - 1)), 3),
                     scene.sink("emission"))
        grad = torch.stack([(taps[0] - taps[1]) * 0.5, (taps[2] - taps[3]) * 0.5,
                            (taps[4] - taps[5]) * 0.5], dim=-1)
    g2 = _dot(grad, grad)
    keep = g2 > GRAD_EPS2
    inv = torch.where(keep, torch.rsqrt(torch.where(keep, g2, 1.0)), 0.0)
    normal = -grad * inv[..., None]
    refl = scene.factor_reflection * fetch(scene.reflection, sc)
    light_in = origin - pos
    lut_coords = []
    for lp in scene.light_positions:
        light_out = lp - pos
        a = angle(normal, light_in) / math.pi
        b = angle(normal, light_out) / math.pi
        lop = light_out - normal * _dot(light_out, normal)[..., None]
        lip = light_in - normal * _dot(light_in, normal)[..., None]
        g = angle(lip, lop) / math.pi
        lut_coords.append(torch.stack([a, b, g], dim=-1))
    lut = fetch(scene.illumination, torch.stack(lut_coords))       # (L, ...)
    weight = (lut[..., None] * scene.light_colors.reshape(-1, *([1] * (sc.dim() - 1)), 3)).sum(0)
    return refl[..., None] * weight * scene.color


# ---- the march -------------------------------------------------------------

def _chunks(n: torch.Tensor, chunk_samples: int):
    """Index sets of rays, longest first, about ``chunk_samples`` samples
    (rays times the longest) each."""
    order = torch.argsort(n, descending=True)
    lengths = n[order].tolist()
    i = 0
    while i < len(lengths) and lengths[i] > 0:
        rows = max(1, chunk_samples // lengths[i])
        yield order[i:i + rows], lengths[i]
        i += rows


def _march_chunk(scene: RefScene, c: Consts, r: Rays, sel: torch.Tensor, length: int,
                 dtype) -> torch.Tensor:
    """(rows, 3) premultiplied colour of the rays ``sel``."""
    dev = sel.device
    k = torch.arange(length, device=dev, dtype=dtype)
    pos = r.pos0[sel, None, :] + k[None, :, None] * r.step[sel, None, :]
    bmin = torch.tensor(c.boxmin, dtype=dtype, device=dev)
    scale = 1.0 / (torch.tensor(c.boxmax, dtype=dtype, device=dev) - bmin)
    sc = (pos - bmin) * scale
    absorption = scene.factor_absorption * fetch(scene.absorption, sc, scene.sink("absorption"))
    alpha = 1.0 - torch.exp(-absorption * c.tstep)
    inside = torch.arange(length, device=dev)[None, :] < r.n_geo[sel, None]
    with torch.no_grad():
        # sample k + 1 is composited only while the opacity after k is at or
        # below the threshold
        opacity = 1.0 - torch.cumprod(1.0 - torch.where(inside, alpha, 0.0).to(torch.float64),
                                      dim=1)
        over = torch.cat([torch.zeros_like(opacity[:, :1], dtype=torch.bool),
                          opacity[:, :-1] > scene.opacity_threshold], dim=1)
        live = inside & (torch.cumsum(over.to(torch.int32), dim=1) == 0)
    alpha = torch.where(live, alpha, 0.0)
    emission = scene.factor_emission * fetch(scene.emission, sc, scene.sink("emission"))
    rgb = (emission * c.tstep)[..., None] * scene.color
    if scene.light_positions.shape[0]:
        rgb = rgb + _shade(scene, c, pos, sc, r.origin)
    trans = torch.cumprod(1.0 - alpha, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    return ((trans * alpha)[..., None] * rgb).sum(dim=1)


def render_pixels(scene: RefScene, pixels: torch.Tensor, *, dtype=torch.float64,
                  chunk_samples: int = 1 << 22) -> torch.Tensor:
    """The (N, 3) colour of the flat pixels ``pixels`` (y * W + x), no
    gradient."""
    c = consts(tuple(scene.emission.shape[:3]), scene.element_size_um)
    r = rays(scene, c, pixels, dtype)
    out = torch.zeros((pixels.shape[0], 3), dtype=dtype, device=pixels.device)
    with torch.no_grad():
        for sel, length in _chunks(r.n_geo, chunk_samples):
            out[sel] = _march_chunk(scene, c, r, sel, length, dtype)
    return out


def render_image(scene: RefScene, **kw) -> torch.Tensor:
    """The whole (H, W, 3) image."""
    dev = scene.emission.device
    pixels = torch.arange(scene.width * scene.height, device=dev)
    return render_pixels(scene, pixels, **kw).reshape(scene.height, scene.width, 3)


def loss_and_grads(scene: RefScene, target: torch.Tensor, *, dtype=torch.float64,
                   chunk_samples: int = 1 << 21,
                   keep_rows: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sum((image - target)^2)`` over the whole image and its gradient in
    every leaf of ``scene`` that requires grad (accumulated into ``.grad``
    chunk by chunk). Returns (loss, image). ``keep_rows`` (a fault of the
    loss, for the checks' own tests): a mask of the pixels that count."""
    dev = scene.emission.device
    c = consts(tuple(scene.emission.shape[:3]), scene.element_size_um)
    pixels = torch.arange(scene.width * scene.height, device=dev)
    r = rays(scene, c, pixels.detach(), dtype)
    r = Rays(pixels=r.pixels, origin=r.origin.detach(), pos0=r.pos0.detach(),
             step=r.step.detach(), n_geo=r.n_geo)
    tgt = target.reshape(-1, 3).to(dtype)
    weight = torch.ones(pixels.shape[0], dtype=dtype, device=dev)
    if keep_rows is not None:
        weight = keep_rows(pixels).to(dtype)
    image = torch.zeros((pixels.shape[0], 3), dtype=dtype, device=dev)
    leaves = {k: getattr(scene, k) for k in ("emission", "absorption")
              if getattr(scene, k).requires_grad}
    scene = scene.replace(sinks={k: torch.zeros(v.numel(), dtype=v.dtype, device=dev)
                                 for k, v in leaves.items()})
    hit = r.n_geo > 0
    loss = (weight[~hit, None] * tgt[~hit] ** 2).sum().detach()
    for sel, length in _chunks(r.n_geo, chunk_samples):
        rgb = _march_chunk(scene, c, r, sel, length, dtype)
        part = (weight[sel, None] * (rgb - tgt[sel]) ** 2).sum()
        part.backward()
        loss = loss + part.detach()
        image[sel] = rgb.detach()
    for k, v in leaves.items():
        v.grad = scene.sinks[k].reshape(v.shape)
    return loss, image.reshape(scene.height, scene.width, 3)


class Adam:
    """``torch.optim.Adam``'s update with its defaults (no weight decay,
    no amsgrad), written out, on a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(1 - b2 ** self.t)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
            p.grad = None
