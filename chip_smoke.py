#!/usr/bin/env python3
"""Drives the PyTorch port (volume_renderer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out FILE] [--parent DIR]

Phases, one JSON line each; any failure raises and exits nonzero:

1. device:  the card, its power limit, and the build of every kernel
            source (one nvcc each, started together), with the registers,
            spills and resulting blocks an SM that ptxas reports for each
            kernel instantiation. K1, K3, K4, K6, K7 phase 2 and the K7
            gradient segment must not spill.
2. goldens: the five tests/goldens scenes through VolumeRenderer on the
            card, held against the committed images.
3. kernel_vs_plain: the forward march kernel against its plain PyTorch
            version (ops/forward.py) on the card at 128^3 / 256x192, per
            mode, unlit (K1) also with absorption of another shape, and
            lit (K4) on an anisotropic (36, 24, 64) volume and on a 48^3
            one seen near an axis (taps on faces and edges). K1 and K4
            must equal their plain versions exactly, here and wherever
            else they are compared.
4. grads_vs_plain: the backward march kernel through voxel_grads_fast (K3
            unlit, K6 lit) and transfer_grads_fast (K2) against its plain
            version (ops/vjp.py:replay_backward) at 128^3 / 256x192, K3
            also with absorption of another shape, K6 on the two lit
            scenes of phase 3, every gradient key (K3's grids within 1e-5
            of scale, every other key within 1e-4).
5. main_path: VolumeRenderer.render() at 256^3 / 512^2 for the unlit (K1),
            lit on-the-fly (K4) and lit lookup (K5) flagship scenes, with
            the launch counts set to 0 just before and read just after;
            each image is held against the plain version on the whole image.
6. train_main_path: at 256^3 / 512^2, three Adam steps of
            train.train_step_fast on the unlit scene (K1 + K3 a step) and on
            the lit one (K4 + K6), and a three-step transfer-parameter fit
            through transfer_grads_fast (K1 + K2), counted like phase 5.
            The loss must fall. Before the counted steps, the first step's
            gradients are held against the plain replay on a 64-row band.
7. timing:  the forward kernel (CUDA events, warm, median of 5) and the
            plain version at 256^3 / 512^2 (K1, K4, K5) and 512^3 / 1024^2
            (K1, K4; the plain version on a 64-row band through the
            middle), with rays/s, the march samples the rays took and the
            bound; then the forward + backward pair, the backward kernel
            alone and the whole training step for K3, K6 and K2 at
            256^3 / 512^2 and K3 at 512^3 / 1024^2, with the bound, and
            K3's atomic adds a sample at 256^3 / 512^2, counted from the
            plain march's positions (march_flushes). gather_footprint, the
            model of the sectors and lines K1's warp loads touch, is not
            run here: call it on a scene and a band of rows.

8. bricks_vs_plain: the z-brick kernels (K7) at 128^3 / 256x192, 4 bricks:
            each launch form on every brick (phase 1 opacity and entry
            record, phase 2 contribution and exit opacity, the gradient
            segment's padded grids and parameter sums) against its plain
            pass (ops/brick_march.py) on the same inputs, for cameras whose
            rays rise in z, fall in z and do both, and for an absorption
            volume of another shape than emission's; the records and the
            forward phases must equal their plain versions to the bit; the
            bricked image against the single-device kernel's; a lit scene,
            which the fast entry points must refuse and the plain bricked
            render must get right.
9. bricks_main_path: at 256^3 / 512^2 on the noisy K3 scene, the launch
            forms against their plain passes on a 64-row band; then, counted
            like phase 5, render_forward_bricked_fast with 4 and 8 bricks,
            also on a dense scene with opacity threshold 0.3 (rays die
            mid-volume), one voxel_grads_bricked_fast call and three Adam
            steps of train_step_fast_bricked. Expected launches: 2 a brick
            and render, 3 a brick and gradient call or step. Images and
            first-step gradients are held against the single-device kernels,
            and the loss must fall.
10. bricks_timing: with 4 bricks, each launch form over all bricks, the
            bricked forward, forward + backward and training step (CUDA
            events, warm, median of 5) beside the single-device kernels on
            the same scene, with the samples each phase took and the bound;
            the atomic adds a sample of the gradient segment's corner carry,
            counted from the plain walk (corner_flushes); the launch forms
            and the bricked
            forward on the dense scene too, where the walk to a brick was a
            larger share of a ray's work.
11. parent_vs_new, only with --parent DIR: DIR holds another version of
            the port's package (e.g. the parent commit's, unpacked with git
            archive). Timed in turns, DIR's, the checkout's, the checkout's,
            DIR's, each version in a process of its own that builds and
            imports it and runs its turns when asked (the other waits), a
            median of 5 each: K1 and K4 (256^3 / 512^2,
            512^3 / 1024^2; the images must be equal), K3 and K6 (the
            backward alone, forward + backward, the training step,
            256^3 / 512^2) and K7 with 4 bricks at 256^3 / 512^2 (each launch
            form over all bricks, phase 2 alone from phase 1's outputs; the
            bricked forward, forward + backward and training step; the
            host's time in phase 2's calls, in their record checks and in
            the bricked forward; the bricked images and every brick's exit
            opacity must be equal).

Then the kernels line and, last, {"ok": true, "device": {...}}. It needs
the repository around it and a CUDA card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"
# volume edge and image size of the phases
COMPARE = dict(volume=128, width=256, height=192)
MAIN = dict(volume=256, image=512)
BIG = dict(volume=512, image=1024, band=64)
# Training steps, the plain replay's band rows, and Adam's rates. Lit, the
# loss feels the emission grid through the normals (differences of
# neighbouring voxels, about 0.01 here) and the sharp LUT: its emission
# gradient is 1e5 times the unlit one, and steps of 2e-5 per voxel already
# scramble the normals and raise the loss.
TRAIN_STEPS, BAND = 3, 64
TRAIN_LR = {"K3": 2e-3, "K6": 2e-6, "K2": 1e-2}

# Published peaks of one H100 SXM at its full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# float32 operations of one march step, the least the step's function needs
# (a transcendental counts as one, index math as none), whatever a kernel
# does: one axis's coordinate is 2 (sub, mul), its corner and weight 6
# (mul, sub, floor, sub, 2 clamps), a lerp 3. A trilinear fetch at a
# position of its own is 39: three corners and 7 lerps. A volume of the
# emission's shape (every scene here, checked where the bounds are taken)
# is fetched at the emission's corners: 7 lerps.
_AXIS_COORD, _AXIS_CORNER, _LERP = 2, 6, 3
_COORDS, _BLEND = 3 * _AXIS_COORD, 7 * _LERP
_FETCH = 3 * _AXIS_CORNER + _BLEND
_STEP_UNLIT = _COORDS + _FETCH + 2 + 4 + 6 + 10 + 1 + 2 + 3  # + composite, t, stop, pos
# The six emission taps, half a voxel from the centre as in every timed
# scene: a tap's coordinate and corner on its own axis (the other two are
# the centre's, float for float) and 27 lerps, a lerp shared where it is the
# same one on the same floats (x taps 2 x 7; y taps 2 on the extra rows +
# 2 x 3; z taps 2 + 1 + 2), then the three differences.
_STEP_OTF_TAPS = 6 * (1 + _AXIS_COORD + _AXIS_CORNER) + 27 * _LERP + 6
_STEP_LOOKUP_TAPS = 3 * _BLEND
_STEP_NORMAL = 11 + 1  # + factor_reflection * re
_STEP_PER_LIGHT = 3 + 3 + 3 * 23 + 22 + _FETCH + 1 + 9


def flops_per_step(mode: str, ab_aliased: bool, re_aliased: bool, n_lights: int) -> int:
    ops = _STEP_UNLIT + (0 if ab_aliased else _BLEND)
    if mode != "K1":
        ops += (0 if re_aliased else _BLEND) + _STEP_NORMAL + 3 + n_lights * _STEP_PER_LIGHT
        ops += _STEP_LOOKUP_TAPS if mode == "K5" else _STEP_OTF_TAPS
    return ops


# float32 operations of one backward step, counted the same way: the
# replayed forward step with the under operator's cotangents and the per-ray
# sums. A scatter at the centre reuses the replay's corners: the weights'
# complements and y-z products are 7, the eight trilinear weights 8 more,
# and a cotangent spread over them 8 products and 8 atomic adds. Lit, the
# centre's and the six taps' emission scatters go to the 20 voxels of their
# window at half-voxel taps, one atomic add each, after 74 operations: the
# taps' weights by window slot 9, the x slots' centre-and-tap terms 7, the
# y and z taps' terms 6, the four centre rows 4 x 10, the four rows of the
# y and z taps alone 4 x 3.
_CORNER_WEIGHTS, _X_WEIGHTS, _SCATTER = 3 + 4, 8, 8 + 8
_EM_TAPS_SCATTER = 9 + 7 + 6 + 4 * 10 + 4 * 3 + 20
_BWD_STEP = 99
_BWD_PER_LIGHT = 145      # forward terms, per-light sums, d contrib, d reflection
_BWD_LIT = _STEP_OTF_TAPS + 12 + 1 + 3 + 5 + 6 + 2  # taps, normal, light_in
_BWD_PER_LIGHT_CHAIN = 26 + 1 + 3 * (54 + 2) + 10 + 30  # LUT derivatives, 3 angle adjoints, d n
_BWD_D_GRADIENT = 20      # the taps' cotangents from the normal's


def bwd_flops_per_step(lit: bool, scatter: bool, ab_aliased: bool, re_aliased: bool,
                       n_lights: int) -> int:
    ops = _BWD_STEP + (0 if ab_aliased else _BLEND)
    if lit:
        ops += (0 if re_aliased else _BLEND) + _BWD_LIT + n_lights * _BWD_PER_LIGHT
    if scatter:
        # the eight weights, for every volume scattered as one sample
        eight = not lit or not ab_aliased or not re_aliased
        ops += 7 + 1 + _CORNER_WEIGHTS + (_X_WEIGHTS if eight else 0)
        ops += (_BWD_D_GRADIENT + _EM_TAPS_SCATTER) if lit else _SCATTER
        ops += 1 if ab_aliased else _SCATTER
        if lit:
            ops += n_lights * _BWD_PER_LIGHT_CHAIN + 1 + (1 if re_aliased else _SCATTER)
    return ops


# float32 operations of csrc/brick_common.cuh and brick_fwd.cu per composited
# sample: the walk (to_sample, owner, owner and opacity tests, t, tfar test,
# position) is 17, alpha 4, the opacity update 3, the shaded composite 16.
_BRICK_WALK = _COORDS + 4 + 2 + 1 + 1 + 3


def brick_flops_per_sample(form: str, ab_aliased: bool) -> int:
    """form: transmittance (phase 1), segment (phase 2) or scatter."""
    if form == "transmittance":
        return _BRICK_WALK + _FETCH + 4 + 3
    if form == "segment":
        return _BRICK_WALK + _FETCH + (0 if ab_aliased else _BLEND) + 4 + 3 + 16
    # the single-device backward step plus the owner (mul, floor, 2 clamps, test)
    return bwd_flops_per_step(False, True, ab_aliased, True, 0) + 5


class CarryCount:
    """The atomic adds that the corner carry (``csrc/corner_carry.cuh``,
    ``CornerCarry``) makes into one carried grid of ``dims`` (x, y, global
    z) for ``n`` rays, when every sample's cotangent is nonzero; 8 a sample
    without the carry. ``visit`` takes each step's normalized positions and
    the rays that composite there: a ray's first sample flushes nothing, a
    later one in another cell the 8 corners minus those both cells share, and
    the ray's last cell its 8 corners (an upper bound: the kernel skips a
    flush of an exact zero)."""

    def __init__(self, n, dims, device):
        import torch
        self.dims = dims
        self.cell = torch.zeros((n, 3), dtype=torch.int64, device=device)
        self.seen = torch.zeros(n, dtype=torch.bool, device=device)
        self.flushes = torch.zeros(n, dtype=torch.int64, device=device)

    def visit(self, s, act):
        import torch
        new = torch.stack([torch.clamp(torch.floor(c * float(d) - 0.5), -1.0, float(d))
                           for c, d in zip(s, self.dims)], dim=-1).to(torch.int64)
        step = (new - self.cell).abs()
        shared = torch.where((step <= 1).all(dim=-1), (2 - step).prod(dim=-1), 0)
        self.flushes.add_(torch.where(act & self.seen, 8 - shared, 0))
        self.cell.copy_(torch.where(act[:, None], new, self.cell))
        self.seen.logical_or_(act)

    def total(self):
        return int(self.flushes.sum()) + 8 * int(self.seen.sum())


def corner_flushes(brick, opts, w_in, entry):
    """``(samples, flushes)``: the samples of a brick's gradient segment from
    the entry opacity ``w_in`` and phase 1's ``entry`` record, and the atomic
    adds into one carried grid that the kernel's corner carry makes for them
    (CarryCount), counted from the plain walk's positions. The cells are
    emission's; a grid of another shape is carried on cells of its own,
    which this does not count."""
    import torch
    from volume_renderer_tpu_torch.ops import brick_march
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    with torch.no_grad():
        rays = brick_march.BrickRays(brick, opts, 0.0)
        consts = rays.consts
        em = brick.scene.emission.data
        dims = (em.shape[2], em.shape[1], brick.slab_geometry(em)[1])  # x, y, global z
        sample_ab = brick_march.brick_samplers(brick).ab
        carry = CarryCount(rays.tnear.numel(), dims, em.device)

        def composite(pos, act, sw):
            s = core.to_sample_coords(pos, consts)
            carry.visit(s, act)
            ab = sample_ab(s)
            return 1.0 - torch.exp(-(consts.factor_absorption * ab) * consts.tstep)

        steps = torch.zeros((rays.n_rows, opts.width), dtype=torch.int32, device=em.device)
        rays.walk(w_in, composite, steps, entry)
        return int(steps.sum()), carry.total()


def march_samples(scene, opts, y0=0, rows=None):
    """The plain march of ``rows`` image rows from ``y0``: its constants, each
    ray's first position and step (flat, r = y * W + x), and its number of
    samples; sample k of a ray lies at its first position plus k
    accumulated steps."""
    import torch
    from volume_renderer_tpu_torch.ops.forward import _init_rays, render_rows

    rows = opts.height if rows is None else rows
    steps = torch.zeros((rows, opts.width), dtype=torch.int32, device=scene.device)
    render_rows(scene, opts, 0.0, y0, rows, steps=steps)
    consts, _, pos, step, _, _, _ = _init_rays(scene, opts, 0.0, y0, rows)
    return consts, pos, step, steps.reshape(-1)


def march_flushes(scene, opts):
    """``(samples, {grid: flushes})``: the samples of K3 (``csrc/march_bwd.cu``,
    march_bwd_scatter_kernel) on the whole image and the atomic adds of its
    corner carry into each gradient grid (CarryCount), counted from the
    plain march's positions. Absorption of emission's shape shares its cells;
    one of another shape is carried on cells of its own."""
    import torch
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    with torch.no_grad():
        consts, pos, step, steps = march_samples(scene, opts)

        def dims(v):
            return (v.shape[2], v.shape[1], v.shape[0])

        em = scene.emission.data
        carries = {"emission": CarryCount(steps.numel(), dims(em), em.device)}
        if not scene.absorption_aliased:
            ab = scene.absorption.data
            carries["absorption"] = (carries["emission"] if ab.shape == em.shape
                                     else CarryCount(steps.numel(), dims(ab), em.device))
        distinct = list({id(c): c for c in carries.values()}.values())
        for k in range(int(steps.max())):
            s = core.to_sample_coords(pos, consts)
            for carry in distinct:
                carry.visit(s, steps > k)
            pos = pos + step
        return int(steps.sum()), {grid: carry.total() for grid, carry in carries.items()}


# A 128-byte line of the tiled layout that K1's gather model compares: 4 x 4 x 2 voxels.
TILE = (4, 4, 2)


def sector_counts(ix, iy, iz, act, dims, tile=TILE, by=None):
    """The 32-byte sectors and 128-byte lines of a float32 volume of ``dims``
    (x, y, z) that warp load instructions touch: ``ix``, ``iy``, ``iz``
    (..., 32) are each lane's voxel, ``act`` (..., 32) whether the lane
    loads. Summed over the instructions, for the x-linear layout (x fastest,
    as the volumes are) and for a tiled one (``tile`` voxels a line, x
    fastest inside it, the lines in x-fastest order). Returns
    {layout: (sectors, lines)}; with ``by``, a tensor (n, 4) of the linear
    sectors and lines, then the tiled ones, for each index n of dimension
    ``by`` of the inputs."""
    import torch

    w, h, _ = dims
    tx, ty, tz = tile
    linear = ix + w * (iy + h * iz)
    lines = ix // tx + (-(-w // tx)) * (iy // ty + (-(-h // ty)) * (iz // tz))
    inside = ix % tx + tx * (iy % ty + ty * (iz % tz))
    ids = torch.stack([linear // 8, linear // 32, lines * (tx * ty * tz // 8) + inside // 8, lines])
    ids = torch.where(act, ids, -1).sort(dim=-1).values
    distinct = (ids[..., 1:] != ids[..., :-1]).sum(-1) + 1 - (ids[..., 0] == -1).long()
    if by is not None:  # dimension by of the inputs is dimension by + 1 of distinct
        return distinct.movedim(by + 1, 1).reshape(4, distinct.shape[by + 1], -1).sum(-1).T
    sums = [int(v) for v in distinct.reshape(4, -1).sum(-1)]
    return {"linear": (sums[0], sums[1]), "tiled": (sums[2], sums[3])}


def warp_lanes(width, rows, warp_cols):
    """(warps, 32) the flat band pixel (r = y * width + x) of each lane of
    the warps of 16x16 blocks whose warps cover warp_cols x 32 / warp_cols
    pixels, the warps of a block side by side, then row by row. 16 columns
    is threadIdx order, K1's (csrc/march_fwd.cu)."""
    import torch

    assert width % 16 == 0 and rows % 16 == 0 and 16 % warp_cols == 0
    t = torch.arange(256)
    lane, warp = t % 32, t // 32
    across = 16 // warp_cols
    lx = (warp % across) * warp_cols + lane % warp_cols
    ly = (warp // across) * (32 // warp_cols) + lane // warp_cols
    bx = torch.arange(width // 16)[None, :, None] * 16
    by = torch.arange(rows // 16)[:, None, None] * 16
    return ((by + ly) * width + bx + lx).reshape(-1, 32)


def gather_footprint(scene, opts, y0, rows, warp_cols=(16, 8, 4)):
    """K1's gather model on ``rows`` image rows from ``y0``: from the plain
    march's positions, for each warp shape and layout (sector_counts), the
    sectors and lines that the 8 corner loads of one volume of emission's
    shape touch, by warp load instruction and by sample."""
    import torch
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    with torch.no_grad():
        consts, pos, step, steps = march_samples(scene, opts, y0, rows)
        d, h, w = scene.emission.data.shape
        dev = steps.device
        # every warp shape's lanes, one after the other: one count a step
        idx = torch.stack([warp_lanes(opts.width, rows, c) for c in warp_cols]).to(dev)
        counts = torch.zeros((len(warp_cols), 5), dtype=torch.int64, device=dev)
        for k in range(int(steps.max())):
            s = core.to_sample_coords(pos, consts)
            lo = [torch.clamp(torch.floor(c * float(n) - 0.5), -1.0, float(n)).to(torch.int64)
                  for c, n in zip(s, (w, h, d))]
            corners = [[torch.clamp(i + j, 0, n - 1) for j in (0, 1)] for i, n in zip(lo, (w, h, d))]
            # corner a + 2 b + 4 c: (x + a, y + b, z + c), by shape, warp and lane
            xyz = [torch.stack([corners[axis][(k8 >> axis) & 1] for k8 in range(8)])[:, idx]
                   for axis in range(3)]
            act = (steps > k)[idx]
            counts[:, :4] += sector_counts(*xyz, act[None].expand(8, -1, -1, -1), (w, h, d),
                                           by=1)
            counts[:, 4] += 8 * act.any(-1).sum(-1)
            pos = pos + step
        totals = {c: {"linear": [int(v) for v in row[:2]], "tiled": [int(v) for v in row[2:4]],
                      "instructions": int(row[4])} for c, row in zip(warp_cols, counts.cpu())}
        samples = int(steps.sum())
        out = {"rows": [y0, rows], "samples": samples, "tile": list(TILE)}
        for c, t in totals.items():
            n = t["instructions"]
            out[f"warp_{c}x{32 // c}"] = {
                "instructions": n,
                **{layout: {"sectors": t[layout][0], "lines": t[layout][1],
                            "sectors_per_instruction": t[layout][0] / n,
                            "lines_per_instruction": t[layout][1] / n,
                            "sectors_per_sample": t[layout][0] / samples,
                            "lines_per_sample": t[layout][1] / samples}
                   for layout in ("linear", "tiled")}}
        return out


# Template parameters of each kernel of csrc/, in order, and the mode that a
# set of their values makes.
KERNEL_PARAMS = {
    "march_kernel": ("LIT", "LOOKUP", "AB_ALIASED", "RE_ALIASED"),
    "march_bwd_kernel": ("LIT", "SCATTER", "AB_ALIASED", "RE_ALIASED"),
    "march_bwd_scatter_kernel": ("AB_ALIASED", "AB_OWN_CELL"),
    "march_bwd_lit_scatter_kernel": ("AB_ALIASED", "RE_ALIASED"),
    "brick_fwd_kernel": ("SHADE", "AB_ALIASED"),
    "brick_bwd_kernel": ("AB_ALIASED", "AB_OWN_CELL"),
}
# Threads a block, where it is not 16x16 (K3, K6 and the K7 gradient
# segment run in 16x8 blocks: csrc/march_bwd.cu, csrc/brick_bwd.cu)
KERNEL_THREADS = {"march_bwd_scatter_kernel": 128, "march_bwd_lit_scatter_kernel": 128,
                  "brick_bwd_kernel": 128}
# 4 bricks, all on the one card
BRICKS = 4


def kernel_mode_of(kernel: str, args) -> str:
    if kernel == "march_kernel":
        return "K1" if not args[0] else ("K5" if args[1] else "K4")
    if kernel == "march_bwd_kernel":
        return "K2" if not args[1] else ("K6" if args[0] else "K3")
    if kernel == "march_bwd_scatter_kernel":
        return "K3"
    if kernel == "march_bwd_lit_scatter_kernel":
        return "K6"
    if kernel == "brick_fwd_kernel":
        return "K7_segment" if args[0] else "K7_transmittance"
    return "K7_scatter"


def blocks_per_sm(registers: int, threads: int) -> int:
    """Blocks of ``threads`` that the registers of an H100 SM hold: 65,536
    of them, allocated to a warp in units of 256, at most 64 warps and 32
    blocks an SM."""
    per_warp = -(-registers * 32 // 256) * 256
    return min(min(65536 // per_warp, 64) // (threads // 32), 32)


def ptxas_by_kernel(log: str, strict: bool = True) -> dict:
    """What ``nvcc -Xptxas -v`` reports for each kernel instantiation, keyed
    "<mode> <kernel><template arguments>", e.g. "K6 march_bwd_kernel<1,1,0,0>".
    With ``strict`` a kernel must have the template arguments that
    KERNEL_PARAMS lists. Without it (another version of the sources) a
    kernel whose arguments differ is reported without its blocks an SM,
    since its block shape is not known here."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(%s)I((?:Lb[01]E)+)E" % "|".join(KERNEL_PARAMS),
                      line)
        if m:
            args = [int(b) for b in re.findall(r"Lb([01])E", m.group(2))]
            known = len(args) == len(KERNEL_PARAMS[m.group(1)])
            assert known or not strict, line
            key = f"{kernel_mode_of(m.group(1), args)} {m.group(1)}<{','.join(map(str, args))}>"
            out[key] = {"threads": KERNEL_THREADS.get(m.group(1), 256) if known else None}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            out[key].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            out[key]["registers"] = int(m.group(1))
            if out[key]["threads"]:
                blocks = blocks_per_sm(int(m.group(1)), out[key]["threads"])
                out[key].update(blocks_per_sm=blocks,
                                warps_per_sm=blocks * out[key]["threads"] // 32)
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every JSON line to this file")
    parser.add_argument("--parent", metavar="DIR",
                        help="a directory holding another version of volume_renderer_tpu_torch/ "
                             "(e.g. the parent commit's): its K1, K3, K4, K6 and K7 are timed in "
                             "turns with the checkout's (phase 11)")
    parser.add_argument("--turn", action="store_true",
                        help="phase 11's turns: build, then for each line read on stdin time K1, "
                             "K3, K4, K6 and K7 and print one JSON line")
    parser.add_argument("--repo", metavar="DIR", default=REPO,
                        help="import the port from DIR instead of the checkout around this script")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.repo))

    from volume_renderer_tpu_torch import (
        Camera, LightSource, RenderSettings, Scene, StereoRenderMode, Volume, VolumeRenderer,
        henyey_greenstein_lut)
    from volume_renderer_tpu_torch import train
    from volume_renderer_tpu_torch.ops import _build, brick_march, cuda_bricks, cuda_march
    from volume_renderer_tpu_torch.ops.cuda_grads import (
        grad_mode, march_backward, transfer_grads_fast, voxel_grads_fast)
    from volume_renderer_tpu_torch.ops.cuda_march import kernel_mode, render_forward_fast
    from volume_renderer_tpu_torch.ops.forward import render_forward, render_rows
    from volume_renderer_tpu_torch.ops.vjp import replay_backward
    from volume_renderer_tpu_torch.parallel import bricks
    from volume_renderer_tpu_torch.parallel.mesh import make_mesh

    lines = []
    t_start = time.perf_counter()

    def record(obj):
        if "phase" in obj:
            obj["elapsed_s"] = time.perf_counter() - t_start
        lines.append(obj)
        emit(obj)

    dev = torch.device(DEVICE)
    kernel_path = "cuda" if dev.type == "cuda" else "plain"
    kind = torch.cuda.get_device_name(0)

    # ---- 1. device and build ------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_by_kernel(_build.build_log(name), strict=not args.turn)
             for name in _build.SOURCES}
    # the redesigned kernels keep every value in registers
    spilled = {k: v for name in _build.SOURCES for k, v in ptxas[name].items()
               if k.split()[0] in ("K1", "K3", "K4", "K6", "K7_segment", "K7_scatter")
               and v["spill_store_bytes"]}
    if spilled and not args.turn:  # a turn may time an older version
        raise RuntimeError(f"ptxas spills in a redesigned kernel: {spilled}")
    record({"phase": "device", "kind": kind, "nvidia_smi": smi_line,
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "ptxas": ptxas})

    max_err = {"K1": 0.0, "K4": 0.0, "K5": 0.0}

    def check(name, got, want, atol, rtol, mode):
        got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.isfinite(got).all(), f"{name}: non-finite values"
        err = float(np.abs(got - want).max())
        if mode is not None:
            max_err[mode] = max(max_err[mode], err)
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)
        # K1 blends as sample() does, and K4's tap fetch reads the voxels of
        # seven sample() calls once each and blends them as those do: their
        # images are their plain versions'
        if mode in ("K1", "K4") and err != 0.0:
            raise RuntimeError(f"{name}: the {mode} kernel is {err:.3e} off its plain version")
        return err

    # ---- scenes: the flagship gaussian shell (__graft_entry__.py) -------
    def shell(n, noise=0.0, shape=None):
        """The shell in an n^3 volume or, with ``shape`` (D, H, W), an
        ellipsoidal one filling that box alike."""
        if shape is None:
            i = torch.arange(n, dtype=torch.float32, device=dev)
            c = (n - 1) / 2.0
            r2 = ((i[None, None, :] - c) ** 2 + (i[None, :, None] - c) ** 2
                  + (i[:, None, None] - c) ** 2) / (c * c)
        else:
            r2 = 0.0
            for axis, m in enumerate(shape):
                c = (m - 1) / 2.0
                i = torch.arange(m, dtype=torch.float32, device=dev).reshape(
                    [m if a == axis else 1 for a in range(3)])
                r2 = r2 + (i - c) ** 2 / (c * c)
        vol = torch.exp(-4.0 * (torch.sqrt(r2) - 0.6) ** 2)
        if noise:
            # Seeded multiplicative noise for the gradient phases. On the
            # smooth shell the normal equals the view direction over the
            # whole camera-facing cap, where the angle adjoint amplifies
            # rounding a thousandfold; real volumes are not that smooth.
            gen = torch.Generator(device=dev)
            gen.manual_seed(n)
            vol = vol * (1.0 + noise * (torch.rand(vol.shape, generator=gen, device=dev) - 0.5))
        return vol.contiguous()

    def flagship(n, mode, n_lights=1, ab_aliased=True, re_aliased=False, noise=0.0, shape=None,
                 element_size=(1.0, 1.0, 1.0), rotate=(125, 25, 0), ab_other_shape=False):
        """``ab_other_shape``: absorption at half the emission's height and
        width (a fetch, and with gradients a carry, of its own)."""
        em = shell(n, noise, shape)
        ramp = torch.linspace(0.5, 1.0, em.shape[2], device=dev)[None, None, :]
        ab = None if ab_aliased else Volume.create((em * ramp).contiguous(), element_size)
        if ab_other_shape:
            ab = Volume.create((em[:, ::2, ::2] * 0.9).contiguous(), element_size)
        lit = {}
        if mode != "K1":
            lit = dict(illumination=henyey_greenstein_lut(32),
                       light_positions=torch.tensor([[2.0, 3.0, -1.5], [-1.0, 2.0, 2.0]],
                                                    device=dev)[:n_lights].contiguous(),
                       light_colors=torch.tensor([[1.0, 1.0, 1.0], [0.5, 0.6, 1.0]],
                                                 device=dev)[:n_lights].contiguous())
            if not re_aliased:
                lit["reflection"] = Volume.create(em.clone(), element_size)
            if mode == "K5":
                lit.update(zip(("gradient_x", "gradient_y", "gradient_z"),
                               Volume.create(em).gradient_volumes()))
        return Scene(
            emission=Volume.create(em, element_size), absorption=ab,
            camera=Camera.create(focal_length=3.0, distance_to_object=6.0).rotate(*rotate),
            settings=RenderSettings.create(factor_emission=1.0, factor_reflection=0.4,
                                           factor_absorption=0.6, color=(1.0, 0.9, 0.8),
                                           opacity_threshold=0.95),
            **lit)

    # tolerances: the kernel repeats the plain version's arithmetic in the
    # same order, without FMA contraction (-fmad=false); what may remain are
    # acosf/expf/rsqrtf ulps, carried when lit through the normal into the LUT
    tol = {"K1": (1e-5, 1e-4), "K4": (3e-5, 3e-4), "K5": (3e-5, 3e-4)}

    # Two lit scenes for the branches of the shared tap fetch
    # (csrc/march_common.cuh), the volumes of tests/test_torch_march.py: a
    # non-cubic anisotropic (36, 24, 64) volume, whose y taps lie 1.33 voxels
    # out (a far axis) and whose z taps 0.56 (near: window slots 0 and 3 both
    # in use); and a 48^3 volume under a camera near the z axis, whose rays
    # enter through a face and leave through the side faces and edges, where
    # corners and taps clamp.
    ANISOTROPIC = dict(ab_aliased=False, noise=0.05, shape=(36, 24, 64),
                       element_size=(1.0, 1.0, 1.6), rotate=(70, 20, 5))
    FACES = dict(ab_aliased=False, noise=0.05, rotate=(3, 2, 0))

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def median_ms(fn, reps=5):
        fn()  # warm
        torch.cuda.synchronize()
        times = [timed(fn)[1] for _ in range(reps)]
        return float(np.median(times)), times

    def host_ms(fn, reps=5):
        """The host's time in ``fn`` from an idle card, waits for the card
        inside it included (perf_counter, warm, median of ``reps``)."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(times))

    def brick_scene(n, rot, ab_aliased=False, factor_absorption=0.6, opacity_threshold=0.95,
                    ab_other_shape=False):
        """The noisy unlit flagship scene under another camera and settings."""
        scene = flagship(n, "K1", ab_aliased=ab_aliased, noise=0.05, ab_other_shape=ab_other_shape)
        return scene.replace(
            camera=Camera.create(focal_length=3.0, distance_to_object=6.0).rotate(*rot),
            settings=RenderSettings.create(factor_emission=1.0, factor_reflection=0.4,
                                           factor_absorption=factor_absorption,
                                           color=(1.0, 0.9, 0.8),
                                           opacity_threshold=opacity_threshold))

    def digest(tensors):
        h = hashlib.sha1()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def forward_turn(mode):
        """The forward kernel of ``mode`` (K1 or K4) at 256^3 / 512^2 and
        512^3 / 1024^2, timed as phase 7 times it, with a digest of each
        image."""
        out = {}
        for cfg in (MAIN, BIG):
            scene = flagship(cfg["volume"], mode, ab_aliased=False)
            opts = scene.options(cfg["image"], cfg["image"])
            img = render_forward_fast(scene, opts)
            out[f"{mode}_{cfg['volume']}_{cfg['image']}"] = {
                "ms": median_ms(lambda: render_forward_fast(scene, opts))[0],
                "image_sha1": digest([img])}
            del scene, img
            torch.cuda.empty_cache()
        return out

    def grads_turn(mode):
        """The scatter kernel of ``mode`` (K3 or K6) at 256^3 / 512^2 from the
        first training step's state: the backward alone, the forward +
        backward pair and the training step, timed as phase 7 times them."""
        scene = flagship(MAIN["volume"], "K4" if mode == "K6" else "K1", ab_aliased=False,
                         noise=0.05)
        opts = scene.options(MAIN["image"], MAIN["image"])
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            params, static_scene = train.split_params(scene)
            params["emission"].mul_(1.3).add_(0.05)
            merged = train.merge_params(params, static_scene)
            img = render_forward_fast(merged, opts)
            g = 2.0 * (img - target)

            def fwd_bwd():
                image = render_forward_fast(merged, opts)
                return voxel_grads_fast(merged, opts, 2.0 * (image - target), image=image)

            ms = {"backward_ms": median_ms(lambda: march_backward(merged, opts, g, img))[0],
                  "fwd_bwd_ms": median_ms(fwd_bwd)[0]}
        optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR[mode])
        ms["train_step_ms"] = median_ms(
            lambda: train.train_step_fast(params, optimizer, static_scene, opts, target))[0]
        return {f"{mode}_{MAIN['volume']}_{MAIN['image']}": ms}

    def march_turn():
        """K1 and K4 (forward_turn), K3 and K6 (grads_turn)."""
        return {"ptxas": {name: ptxas[name] for name in ("march_fwd", "march_bwd")},
                **forward_turn("K1"), **forward_turn("K4"), **grads_turn("K3"),
                **grads_turn("K6")}

    def brick_turn():
        """K7 with 4 bricks at 256^3 / 512^2 on the first bricked training
        step's state, timed as phase 10 times it: each launch form over all
        bricks (phase 2 and the gradient segment from phase 1's outputs,
        computed outside the timed calls), the bricked forward, forward +
        backward and training step; the host's time in phase 2's four calls
        and in the bricked forward; with digests of the bricked image and of
        the bricks' exit opacities. Takes a port whose phase 1 returns the
        entry record and one whose phase 1 does not."""
        size = MAIN["image"]
        scene = brick_scene(MAIN["volume"], (125, 25, 0))
        opts = scene.options(size, size)
        out = {"ptxas": {name: ptxas[name] for name in ("brick_fwd", "brick_bwd")}}
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            bparams, bstatic = bricks.split_params_bricked(scene, make_mesh(BRICKS))
            for p in bparams["emission"]:
                p.mul_(1.3).add_(0.05)
            split = bricks.merge_params_bricked(bparams, bstatic)
            fwd = bricks._forward(split, opts, 0.0, fast=True)
            g = 2.0 * (fwd.image - target)
            up_dots = [u.contiguous() for u in bricks._upstream(
                [brick_march.own_dot(g, own) for own in fwd.own], fwd.ascending, torch.cumsum,
                0.0)]
            w_ins = [w.contiguous() for w in fwd.w_in]
            phase1 = [cuda_bricks.brick_transmittance(b, opts) for b in split.bricks]
            records = [p[1:] if isinstance(p, tuple) else () for p in phase1]  # () for an older port
            w_outs = [cuda_bricks.brick_segment(b, opts, 0.0, w, *r)[1]
                      for b, w, r in zip(split.bricks, w_ins, records)]
            out["image_sha1"], out["w_out_sha1"] = digest([fwd.image]), digest(w_outs)
            ms = {
                "transmittance": median_ms(lambda: [cuda_bricks.brick_transmittance(b, opts)
                                                    for b in split.bricks])[0],
                "segment": median_ms(lambda: [
                    cuda_bricks.brick_segment(b, opts, 0.0, w, *r)
                    for b, w, r in zip(split.bricks, w_ins, records)])[0],
                "segment_host": host_ms(lambda: [
                    cuda_bricks.brick_segment(b, opts, 0.0, w, *r)
                    for b, w, r in zip(split.bricks, w_ins, records)]),
                # the part of it that checks the four records' keys
                "record_check_host": host_ms(lambda: [
                    r[0].check(brick_march.Entry.key(b, opts, 0.0))
                    for b, r in zip(split.bricks, records) if r]),
                "scatter": median_ms(lambda: [
                    cuda_bricks.brick_gradients(b, opts, 0.0, g, fwd.image, w, u, *r)
                    for b, w, u, r in zip(split.bricks, w_ins, up_dots, records)])[0],
                "bricked_forward": median_ms(
                    lambda: bricks.render_forward_bricked_fast(split, opts))[0],
                "bricked_forward_host": host_ms(
                    lambda: bricks.render_forward_bricked_fast(split, opts)),
                "bricked_fwd_bwd": median_ms(
                    lambda: bricks.voxel_grads_bricked_fast(split, opts, g))[0],
            }
        optimizer = torch.optim.Adam(bricks.param_leaves(bparams), lr=TRAIN_LR["K3"])
        ms["bricked_train_step"] = median_ms(lambda: bricks.train_step_fast_bricked(
            bparams, optimizer, bstatic, opts, target))[0]
        out["ms"] = ms
        return out

    if args.turn:  # a turn for each line on stdin, until it closes
        emit({"phase": "ready"})
        for _ in sys.stdin:
            t_turn = time.perf_counter()
            out = {"march": march_turn(), "bricks": brick_turn()}
            emit({"phase": "turn", "repo": os.path.abspath(args.repo), **out,
                  "seconds": time.perf_counter() - t_turn})
        return

    # ---- 2. goldens through the facade ----------------------------------
    # the scenes of tests/test_goldens.py, rebuilt with numpy
    def golden_vols(n=18):
        z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
        c = (n - 1) / 2.0
        r2 = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
        em = np.exp(-6.0 * (r2 - 0.55) ** 2).astype(np.float32)
        structure = (np.exp(-8.0 * ((x - c) / c) ** 2)
                     * np.exp(-4.0 * (r2 - 0.3) ** 2)).astype(np.float32)
        return em, structure

    def golden_base(em):
        r = VolumeRenderer()
        r.volume_emission = Volume.create(em)
        r.volume_absorption = Volume.create(em * 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (24, 20)
        return r

    def golden_render(name):
        em, structure = golden_vols()
        r = golden_base(em)
        if name in ("example1_otf", "example1_grad"):
            r.volume_reflection = Volume.create(em)
            r.volume_illumination = henyey_greenstein_lut(16)
            r.light_sources = [LightSource([5, 8, -4], [1.0, 0.7, 0.4])]
        if name == "example1_grad":
            r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                Volume.create(em).gradient_volumes())
            r.factor_emission, r.factor_absorption, r.factor_reflection = 1.2, 0.7, 0.5
        if name == "example3_two_channel":
            r.color = (1.0, 0.3, 1.0)
            r2 = golden_base(structure)
            r2.color = (0.3, 1.0, 0.3)
            return r.render() + r2.render()
        if name == "example2_stereo":
            r.camera_x_offset = 0.25
            r.stereo_output = StereoRenderMode.RED_CYAN
        img = r.render()
        assert r.last_plan.path == kernel_path
        return img

    golden_err = {}
    for name in ("pr1_plain", "example1_otf", "example1_grad", "example3_two_channel",
                 "example2_stereo"):
        golden = torch.from_numpy(np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npy")))
        # the goldens came from the JAX Pallas kernel (closed-form sample
        # positions); the port accumulates positions as the plain path does
        golden_err[name] = check(f"golden {name}", golden_render(name), golden, 1e-4, 1e-3, None)
    record({"phase": "goldens", "atol": 1e-4, "rtol": 1e-3, "max_abs_err": golden_err})

    # ---- 3. kernel vs plain at 128^3 / 256x192 --------------------------
    compare = {}
    for name, mode, kw, offset in (
            ("K1_absorption_aliased", "K1", dict(ab_aliased=True), 0.0),
            ("K1_absorption_separate", "K1", dict(ab_aliased=False), 0.0),
            ("K1_absorption_other_shape", "K1", dict(ab_aliased=False, ab_other_shape=True), 0.0),
            ("K4_two_lights", "K4", dict(n_lights=2, ab_aliased=False), 0.0),
            ("K5_lookup", "K5", dict(), 0.0),
            ("K4_stereo_offset_0.25", "K4", dict(re_aliased=True), 0.25),
            ("K4_anisotropic_36x24x64", "K4", ANISOTROPIC, 0.0),
            ("K4_faces_and_edges_48", "K4", FACES, 0.0)):
        scene = flagship(48 if kw is FACES else COMPARE["volume"], mode, **kw)
        assert kernel_mode(scene) == mode
        opts = scene.options(COMPARE["width"], COMPARE["height"])
        got = render_forward_fast(scene, opts, offset)
        torch.cuda.synchronize()
        compare[name] = check(f"kernel vs plain {name}", got, render_forward(scene, opts, offset),
                              *tol[mode], mode)
    record({"phase": "kernel_vs_plain", "volume": COMPARE["volume"],
            "image": [COMPARE["width"], COMPARE["height"]],
            "tolerance": {k: {"atol": a, "rtol": r} for k, (a, r) in tol.items()},
            "K1_K4_exact": True, "max_abs_err": compare})

    # ---- 4. backward kernel vs plain replay at 128^3 / 256x192 ----------
    # Kernel and plain replay compute each sample's terms with the same
    # float32 arithmetic and differ in the order of their sums: the kernel's
    # atomic adds land in no fixed order, index_add_ and torch.sum have their
    # own. The tolerance is a share of each gradient's largest magnitude.
    # Measured on an H100 at most 1.4e-5 (factor_emission of a lit scene: a
    # scalar whose per-ray terms cancel under a cotangent of mixed sign);
    # typically 3e-7.
    GRAD_TOL = 1e-4
    # The grids that the corner carry scatters (K3's, the K7 gradient
    # segment's against its plain pass, the bricked first step's against the
    # single-device kernels) are held tighter, so that an atomic add that
    # the carry loses or misplaces shows. Measured on an H100 at most
    # 1.9e-6. K3's parameter keys are sums of its per-ray planes, not of the
    # carry, and cancel under a cotangent of mixed sign as the lit scalar
    # does (1.2e-5 of factor_emission's scale with absorption of another
    # shape): they keep GRAD_TOL.
    BRICK_GRAD_TOL = 1e-5
    GRAD_TOLS = {"K3 grids": BRICK_GRAD_TOL, "others": GRAD_TOL}
    grad_err = {"K2": 0.0, "K3": 0.0, "K6": 0.0}       # share of the scale
    grad_abs_err = {"K2": 0.0, "K3": 0.0, "K6": 0.0}

    def check_grads(name, got, want, mode, keys=None):
        """Every key of ``got`` against ``want``; returns the errors by key."""
        if keys is not None:
            assert set(got) == set(keys), (name, sorted(got), sorted(keys))
        errs = {}
        for key, value in got.items():
            a, b = value.double(), want[key].double()
            assert a.shape == b.shape, (name, key, a.shape, b.shape)
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"{name} {key}: non-finite values")
            scale = max(float(b.abs().max()), 1e-30)
            abs_err = float((a - b).abs().max())
            errs[key] = abs_err / scale
            if mode is not None:
                grad_err[mode] = max(grad_err[mode], errs[key])
                grad_abs_err[mode] = max(grad_abs_err[mode], abs_err)
                carried = mode == "K3" and key in ("emission", "absorption")
                if errs[key] > (BRICK_GRAD_TOL if carried else GRAD_TOL):
                    raise RuntimeError(f"{name} {key}: kernel and plain replay differ by "
                                       f"{errs[key]:.3e} of the gradient's scale {scale:.3e}")
        return errs

    def cotangent(height, width, seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return torch.randn((height, width, 3), generator=gen, device=dev) * 1e-3

    transfer_keys = ("factor_emission", "factor_absorption", "factor_reflection", "color",
                     "light_colors")
    grads_compare = {}
    for name, mode, kw, offset, reuse in (
            ("K3_absorption_aliased", "K1", dict(ab_aliased=True), 0.0, False),
            ("K3_absorption_separate_stereo_0.25_image_reuse", "K1", dict(ab_aliased=False),
             0.25, True),
            ("K3_absorption_other_shape", "K1", dict(ab_aliased=False, ab_other_shape=True), 0.0,
             False),
            ("K6_one_light_reflection_separate", "K4", dict(ab_aliased=False), 0.0, False),
            ("K6_two_lights_reflection_aliased_image_reuse", "K4",
             dict(n_lights=2, re_aliased=True), 0.0, True),
            ("K6_anisotropic_36x24x64", "K4", ANISOTROPIC, 0.0, False),
            ("K6_faces_and_edges_48", "K4", FACES, 0.0, False)):
        scene = flagship(48 if kw is FACES else COMPARE["volume"], mode,
                         **{"noise": 0.05, **kw})
        opts = scene.options(COMPARE["width"], COMPARE["height"])
        g = cotangent(COMPARE["height"], COMPARE["width"], seed=len(grads_compare))
        img0 = render_forward_fast(scene, opts, offset) if reuse else None
        img, got = voxel_grads_fast(scene, opts, g, offset, image=img0)
        _, got_transfer = transfer_grads_fast(scene, opts, g, offset, image=img)
        torch.cuda.synchronize()
        assert img0 is None or img is img0
        want = replay_backward(scene, opts, g, img, offset, angle_floor=True)
        bmode = grad_mode(scene, scatter=True)
        grads_compare[name] = {
            "mode": bmode,
            "err_of_scale": check_grads(name, got, want, bmode, keys=want.keys()),
            "K2_err_of_scale": check_grads(name + " K2", got_transfer, want, "K2",
                                           keys=[k for k in want if k in transfer_keys])}
        del scene, got, want
    record({"phase": "grads_vs_plain", "volume": COMPARE["volume"],
            "image": [COMPARE["width"], COMPARE["height"]], "volume_noise": 0.05,
            "tolerance_of_scale": GRAD_TOLS, "max_err_of_scale": dict(grad_err),
            "cases": grads_compare})

    # ---- 5. the main path: VolumeRenderer.render() at 256^3 / 512^2 -----
    def facade(mode):
        em = shell(MAIN["volume"]).cpu().numpy()
        r = VolumeRenderer()
        r.volume_emission = Volume.create(em)
        r.volume_absorption = Volume.create(em)
        r.factor_absorption, r.factor_reflection, r.color = 0.6, 0.4, (1.0, 0.9, 0.8)
        r.focal_length, r.distance_to_object = 3.0, 6.0
        r.rotate(125, 25, 0)
        r.image_resolution = (MAIN["image"], MAIN["image"])
        if mode != "K1":
            r.volume_reflection = Volume.create(em)
            r.volume_illumination = henyey_greenstein_lut(32)
            r.light_sources = [LightSource([2.0, 3.0, -1.5], [1.0, 1.0, 1.0])]
        if mode == "K5":
            r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
                Volume.create(em).gradient_volumes())
        return r

    renderers = {mode: facade(mode) for mode in ("K1", "K4", "K5")}
    for r in renderers.values():  # content hashes for the dedup, outside the window
        r._build_scene()
    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    images = {mode: r.render() for mode, r in renderers.items()}
    torch.cuda.synchronize()
    launches = dict(cuda_march.LAUNCHES_BY_MODE)
    main = {"launches": launches, "total_launches": cuda_march.LAUNCHES}
    for mode, img in images.items():
        if launches[mode] < 1:
            raise RuntimeError(f"the main path launched no {mode} kernel: {launches}")
        assert renderers[mode].last_plan.path == kernel_path
        scene = renderers[mode]._build_scene()
        opts = scene.options(MAIN["image"], MAIN["image"])
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = render_forward(scene, opts)
        end.record()
        end.synchronize()
        main[mode] = {"max_abs_err": check(f"main path {mode}", img, plain, *tol[mode], mode),
                      "plain_ms": start.elapsed_time(end),
                      "nonzero_frac": float((img.amax(-1) > 0).float().mean()),
                      "finite": bool(torch.isfinite(img).all())}
    record({"phase": "main_path", "entry": "VolumeRenderer.render", "volume": MAIN["volume"],
            "image": MAIN["image"], **main})

    # ---- 6. the training main path at 256^3 / 512^2 ---------------------
    size = MAIN["image"]

    def band_check(name, scene, opts, g, img, scatter):
        """The kernel on the whole image, with g zero outside a 64-row band,
        against the plain replay of that band alone."""
        band0 = (opts.height - BAND) // 2
        g_band = torch.zeros_like(g)
        g_band[band0:band0 + BAND] = g[band0:band0 + BAND]
        entry = voxel_grads_fast if scatter else transfer_grads_fast
        _, got = entry(scene, opts, g_band, image=img)
        torch.cuda.synchronize()
        want, plain_ms = timed(lambda: replay_backward(
            scene, opts, g[band0:band0 + BAND].contiguous(), img[band0:band0 + BAND].contiguous(),
            y_offset=band0, n_rows=BAND, angle_floor=True))
        mode = grad_mode(scene, scatter)
        return {"mode": mode, "band_rows": BAND, "plain_ms": plain_ms,
                "err_of_scale": check_grads(name, got, want, mode)}

    def transfer_scene(scene, params):
        return scene.replace(settings=dataclasses.replace(scene.settings, **params))

    def transfer_step(params, optimizer, scene, opts, target):
        """One step of a transfer-function fit: the grids stay fixed."""
        with torch.no_grad():
            merged = transfer_scene(scene, params)
            img = render_forward_fast(merged, opts)
            resid = img - target
            _, grads = transfer_grads_fast(merged, opts, 2.0 * resid, image=img)
            for key, p in params.items():
                p.grad = grads[key]
        optimizer.step()
        return torch.sum(resid ** 2)

    train_scenes = {"K3": flagship(MAIN["volume"], "K1", ab_aliased=False, noise=0.05),
                    "K6": flagship(MAIN["volume"], "K4", ab_aliased=False, noise=0.05)}
    runs, first_step, plain_band_ms = {}, {}, {}
    for mode, scene in train_scenes.items():
        opts = scene.options(size, size)
        target = render_forward_fast(scene, opts)
        params, static_scene = train.split_params(scene)
        with torch.no_grad():
            params["emission"].mul_(1.3).add_(0.05)
        optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR[mode])
        merged = train.merge_params(params, static_scene)
        img = render_forward_fast(merged, opts)
        first_step[mode] = band_check(f"first step {mode}", merged, opts, 2.0 * (img - target),
                                      img, scatter=True)
        plain_band_ms[mode] = first_step[mode]["plain_ms"]
        runs[mode] = (lambda p=params, o=optimizer, sc=static_scene, op=opts, t=target:
                      train.train_step_fast(p, o, sc, op, t))
    # the transfer fit: the unlit scene's factors and color, the grids fixed
    scene = train_scenes["K3"]
    opts = scene.options(size, size)
    target = render_forward_fast(scene, opts)
    tparams = {"factor_emission": scene.settings.factor_emission * 1.3,
               "factor_absorption": scene.settings.factor_absorption * 1.3,
               "color": scene.settings.color * 0.8}
    tparams = {k: v.detach().clone().requires_grad_(True) for k, v in tparams.items()}
    toptimizer = torch.optim.Adam(list(tparams.values()), lr=TRAIN_LR["K2"])
    merged = transfer_scene(scene, tparams)
    img = render_forward_fast(merged, opts)
    first_step["K2"] = band_check("first step K2", merged, opts, 2.0 * (img - target), img,
                                  scatter=False)
    plain_band_ms["K2"] = first_step["K2"]["plain_ms"]
    runs["K2"] = lambda: transfer_step(tparams, toptimizer, scene, opts, target)
    del merged, img

    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    losses = {mode: [float(step()) for _ in range(TRAIN_STEPS)] for mode, step in runs.items()}
    torch.cuda.synchronize()
    train_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    for mode, values in losses.items():
        if train_launches[mode] < TRAIN_STEPS:
            raise RuntimeError(f"the training path launched {mode} {train_launches[mode]} times")
        if not (all(np.isfinite(values)) and all(b < a for a, b in zip(values, values[1:]))):
            raise RuntimeError(f"the {mode} loss did not fall: {values}")
    if train_launches["K1"] < 2 * TRAIN_STEPS or train_launches["K4"] < TRAIN_STEPS:
        raise RuntimeError(f"the training path skipped a forward kernel: {train_launches}")
    record({"phase": "train_main_path",
            "entry": {"K3": "train.train_step_fast (unlit)", "K6": "train.train_step_fast (lit)",
                      "K2": "transfer_grads_fast fit"},
            "volume": MAIN["volume"], "image": size, "steps": TRAIN_STEPS, "optimizer": "Adam",
            "lr": TRAIN_LR, "volume_noise": 0.05,
            "launches": train_launches, "losses": losses, "first_step_vs_plain_band": first_step,
            "tolerance_of_scale": GRAD_TOLS})
    del runs, train_scenes, params, optimizer, static_scene, target, tparams, toptimizer
    torch.cuda.empty_cache()

    # ---- 7. timing at 256^3 / 512^2 and 512^3 / 1024^2 -------------------
    def volume_bytes(scene, mode):
        vols = [scene.emission.data]
        if not scene.absorption_aliased:
            vols.append(scene.absorption.data)
        if mode != "K1":
            vols.append(scene.illumination)
            if not scene.reflection_aliased:
                vols.append(scene.reflection.data)
            if mode == "K5":
                vols += [scene.gradient_x.data, scene.gradient_y.data, scene.gradient_z.data]
        # the operation counts fetch every volume but the LUT at the emission's corners
        assert all(v.shape == vols[0].shape for v in vols if v is not scene.illumination)
        return sum(v.numel() * 4 for v in vols)

    def time_cell(scene, size, band_rows=None, reps=5):
        mode = kernel_mode(scene)
        opts = scene.options(size, size)
        steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
        img = render_forward_fast(scene, opts, steps=steps)  # warm-up, and the step counts
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            render_forward_fast(scene, opts)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times))
        y0 = 0 if band_rows is None else (size - band_rows) // 2
        rows = size if band_rows is None else band_rows
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain = render_rows(scene, opts, 0.0, y0, rows)
        end.record()
        end.synchronize()
        err = check(f"timing cell {mode} {size}", img[y0:y0 + rows], plain, *tol[mode], mode)
        samples = int(steps.sum())
        n_lights = 0 if mode == "K1" else scene.light_positions.shape[0]
        flops = samples * flops_per_step(mode, scene.absorption_aliased,
                                         scene.reflection_aliased, n_lights)
        nbytes = volume_bytes(scene, mode) + size * size * 3 * 4
        bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "operations": flops / PEAK_FP32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        return {"mode": mode, "image": size, "ms": ms, "ms_all": times,
                "rays_per_s": size * size / (ms * 1e-3), "samples": samples,
                "samples_per_ray": samples / (size * size), "flops": flops, "bytes": nbytes,
                "bound_ms": bound[bound_by], "bound_by": bound_by,
                "plain_ms": start.elapsed_time(end), "plain_rows": rows, "max_abs_err": err,
                "finite": bool(torch.isfinite(img).all()),
                "nonzero_frac": float((img.amax(-1) > 0).float().mean())}

    cells = {}
    for cfg, modes, band in ((MAIN, ("K1", "K4", "K5"), None),
                             (BIG, ("K1", "K4"), BIG["band"])):
        for mode in modes:
            key = f"{mode}_{cfg['volume']}_{cfg['image']}"
            scene = flagship(cfg["volume"], mode, ab_aliased=False)
            cells[key] = time_cell(scene, cfg["image"], band_rows=band)
            record({"phase": "timing", "cell": key, "volume": cfg["volume"], **cells[key]})
            del scene
            if DEVICE == "cuda":
                torch.cuda.empty_cache()

    # ---- forward + backward at 256^3 / 512^2 and 512^3 / 1024^2 ---------
    def time_train_cell(scene, size, scatter, plain=None):
        """The first training step's state (emission x 1.3 + 0.05 against a
        target of the true scene): the backward kernel alone, the forward +
        backward pair and, with grids, the whole train_step_fast."""
        mode, fmode = grad_mode(scene, scatter), kernel_mode(scene)
        opts = scene.options(size, size)
        entry = voxel_grads_fast if scatter else transfer_grads_fast
        with torch.no_grad():
            target = render_forward_fast(scene, opts)
            params, static_scene = train.split_params(scene)
            params["emission"].mul_(1.3).add_(0.05)
            merged = train.merge_params(params, static_scene)
            steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
            img = render_forward_fast(merged, opts, steps=steps)
            g = 2.0 * (img - target)
            if plain is None:
                plain = band_check(f"timing cell {mode} {size}", merged, opts, g, img, scatter)
            adds = None
            if mode == "K3" and size == MAIN["image"]:
                # the corner carry's atomic adds, from the plain march (march_flushes)
                n, flushes = march_flushes(merged, opts)
                adds = {"samples": n, "flushes": flushes,
                        "atomic_adds_per_sample": sum(flushes.values()) / n,
                        "atomic_adds_per_sample_uncarried": 8 * len(flushes)}
            bwd_ms, bwd_all = median_ms(
                lambda: march_backward(merged, opts, g, img, scatter=scatter))

            def fwd_bwd():
                image = render_forward_fast(merged, opts)
                return entry(merged, opts, 2.0 * (image - target), image=image)

            pair_ms, pair_all = median_ms(fwd_bwd)
        out = {"mode": mode, "forward_mode": fmode, "image": size, "ms": bwd_ms,
               "ms_all": bwd_all, "fwd_bwd_ms": pair_ms, "fwd_bwd_ms_all": pair_all}
        if adds is not None:
            out["atomic_adds"] = adds
        if scatter:
            optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR[mode])
            out["train_step_ms"], out["train_step_ms_all"] = median_ms(
                lambda: train.train_step_fast(params, optimizer, static_scene, opts, target))
        lit = scene.has_lighting
        n_lights = scene.light_positions.shape[0] if lit else 0
        samples = int(steps.sum())
        flops = samples * bwd_flops_per_step(lit, scatter, scene.absorption_aliased,
                                             scene.reflection_aliased, n_lights)
        # each volume read once, each gradient grid written once, g and the
        # image read once, the per-ray planes written once
        grids = 0
        if scatter:
            grids = scene.emission.data.numel() * 4 * (
                1 + (not scene.absorption_aliased) + (lit and not scene.reflection_aliased))
        nbytes = (volume_bytes(scene, fmode) + grids + 2 * size * size * 3 * 4
                  + (3 + 3 * n_lights) * size * size * 4)
        bound = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3,
                 "operations": flops / PEAK_FP32_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        out.update({"samples": samples, "samples_per_ray": samples / (size * size),
                    "flops": flops, "bytes": nbytes, "bound_ms": bound[bound_by],
                    "bound_by": bound_by, "plain_ms": plain["plain_ms"],
                    "plain_rows": plain["band_rows"],
                    "plain_err_of_scale": plain["err_of_scale"]})
        return out

    for cfg, modes in ((MAIN, ("K3", "K6", "K2")), (BIG, ("K3",))):
        for mode in modes:
            key = f"{mode}_{cfg['volume']}_{cfg['image']}"
            scene = flagship(cfg["volume"], "K4" if mode == "K6" else "K1", ab_aliased=False,
                             noise=0.05)
            # at 256^3 the band was held against the plain replay in phase 6
            plain = first_step[mode] if cfg is MAIN else None
            cells[key] = time_train_cell(scene, cfg["image"], scatter=mode != "K2", plain=plain)
            record({"phase": "timing", "cell": key, "volume": cfg["volume"], **cells[key]})
            del scene
            torch.cuda.empty_cache()


    # ---- 8. the z-brick kernels vs their plain passes at 128^3 / 256x192 --
    K7_FORMS = ("transmittance", "segment", "scatter")
    brick_err = {form: 0.0 for form in K7_FORMS}  # max abs error against the plain pass
    brick_grad_err = [0.0]                        # share of the gradient's scale

    def image_tolerance(name, got, want):
        """A bricked image against the single-device kernel's. The entry
        opacity 1 - prod T equals the sequential recurrence only to
        rounding, so a ray that stops within an ulp of the threshold may
        take one sample more or less. A sample adds about alpha / threshold
        of its pixel, 5e-3 / 0.3 on the dense scene: allowed are 2e-2 of the
        image's largest value (measured 3.9e-3 there), on fewer than 1e-3 of
        the values; everywhere else 1e-5 of it."""
        assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
        scale = float(want.abs().max())
        diff = (got - want).abs()
        err, off = float(diff.max()), float((diff > 1e-5 * scale).float().mean())
        if err > 2e-2 * scale or off > 1e-3:
            raise RuntimeError(f"{name}: bricked and single-device images differ by {err:.3e} "
                               f"(scale {scale:.3e}), {off:.2e} of the values beyond 1e-5")
        return {"max_abs_err": err, "scale": scale, "share_beyond_1e-5_of_scale": off}

    def bricks_compare(name, scene, opts, g, band=None):
        """Every K7 launch form on every brick, on the whole image, against
        its plain pass on the same inputs; the plain passes march the whole
        image or, with ``band``, that many rows through the middle (g is
        then zero outside them)."""
        y0, rows = (0, opts.height) if band is None else ((opts.height - band) // 2, band)
        if band is not None:
            g_band = torch.zeros_like(g)
            g_band[y0:y0 + rows] = g[y0:y0 + rows]
            g = g_band

        def cut(t):
            return t[y0:y0 + rows].contiguous()

        split = bricks.split_bricks(scene, make_mesh(BRICKS))
        fwd = bricks._forward(split, opts, 0.0, fast=True)
        up_dots = bricks._upstream([brick_march.own_dot(g, own) for own in fwd.own],
                                   fwd.ascending, torch.cumsum, 0.0)
        errs = {form: 0.0 for form in K7_FORMS}
        plain_ms = {form: 0.0 for form in K7_FORMS}
        got_grads, want_grads = [], []
        for brick, w_in, up in zip(split.bricks, fwd.w_in, up_dots):
            w_in, up = w_in.contiguous(), up.contiguous()
            w_own, entry = cuda_bricks.brick_transmittance(brick, opts)
            own, w_out = cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry)
            got_grads.append(cuda_bricks.brick_gradients(brick, opts, 0.0, g, fwd.image, w_in, up,
                                                         entry))
            torch.cuda.synchronize()
            band_kw = dict(y_offset=y0, n_rows=rows)
            (p_own, p_entry), ms = timed(lambda: brick_march.transmittance_pass(
                brick, opts, 0.0, **band_kw))
            plain_ms["transmittance"] += ms
            tag = f"{name} brick {brick.index}"
            # positions are stored, not recomputed: the records must be the bit
            band_entry = entry.rows(y0, rows)
            if not (torch.equal(band_entry.step, p_entry.step)
                    and torch.equal(band_entry.state, p_entry.state)):
                raise RuntimeError(f"{tag}: the kernel's entry record differs from the plain one")
            (p_contrib, p_out), ms = timed(lambda: brick_march.shaded_pass(
                brick, opts, 0.0, cut(w_in), entry=band_entry, **band_kw))
            plain_ms["segment"] += ms
            want, ms = timed(lambda: brick_march.replay_pass(
                brick, opts, 0.0, cut(g), cut(fwd.image), cut(w_in), cut(up), angle_floor=True,
                entry=band_entry, **band_kw))
            plain_ms["scatter"] += ms
            want_grads.append(want)
            errs["transmittance"] = max(errs["transmittance"], check(
                f"{tag} phase 1 opacity", cut(w_own), p_own, *tol["K1"], None))
            errs["segment"] = max(
                errs["segment"],
                check(f"{tag} phase 2 contribution", cut(own), p_contrib, *tol["K1"], None),
                check(f"{tag} phase 2 exit opacity", cut(w_out), p_out, *tol["K1"], None))
            # phases 1 and 2 repeat their plain passes' arithmetic in the same order
            if errs["transmittance"] or errs["segment"]:
                raise RuntimeError(f"{tag}: a brick forward phase is off its plain pass: {errs}")
        # the gradient segment: each key as a share of its largest magnitude
        # over the bricks (kernel and plain pass differ in the order of sums)
        grad_errs = {}
        for key in want_grads[0]:
            scale = max(max(float(w[key].abs().max()) for w in want_grads), 1e-30)
            for got, want in zip(got_grads, want_grads):
                assert got[key].shape == want[key].shape, (name, key)
                if not bool(torch.isfinite(got[key]).all()):
                    raise RuntimeError(f"{name} {key}: non-finite values")
                abs_err = float((got[key].double() - want[key].double()).abs().max())
                grad_errs[key] = max(grad_errs.get(key, 0.0), abs_err / scale)
                errs["scatter"] = max(errs["scatter"], abs_err)
            if grad_errs[key] > BRICK_GRAD_TOL:
                raise RuntimeError(f"{name} {key}: brick kernel and plain pass differ by "
                                   f"{grad_errs[key]:.3e} of the gradient's scale {scale:.3e}")
        assert set(got_grads[0]) == set(want_grads[0]), (name, sorted(got_grads[0]))
        for form in K7_FORMS:
            brick_err[form] = max(brick_err[form], errs[form])
        brick_grad_err[0] = max(brick_grad_err[0], max(grad_errs.values()))
        return {"ascending_share": float(fwd.ascending.float().mean()),
                "max_abs_err": errs, "entry_records_equal": True, "grad_err_of_scale": grad_errs,
                "plain_ms": plain_ms, "plain_rows": rows, "image": fwd.image}

    bricks_cases = {}
    for i, (name, rot, kw) in enumerate((
            ("dz_positive", (10, 5, 0), {}),
            ("dz_negative_aliased", (180, 20, 0), dict(ab_aliased=True)),
            ("dz_mixed", (88, 0, 0), {}),
            ("dz_positive_absorption_other_shape", (10, 5, 0), dict(ab_other_shape=True)))):
        scene = brick_scene(COMPARE["volume"], rot, **kw)
        opts = scene.options(COMPARE["width"], COMPARE["height"])
        entry = bricks_compare(name, scene, opts,
                               cotangent(COMPARE["height"], COMPARE["width"], seed=10 + i))
        image = entry.pop("image")
        entry["vs_single_device_kernel"] = image_tolerance(
            name, image, render_forward_fast(scene, opts))
        entry["nonzero_frac"] = float((image.amax(-1) > 0).float().mean())
        bricks_cases[name] = entry
        del scene
    signs = [c["ascending_share"] for c in bricks_cases.values()][:3]
    if not (signs[0] == 1.0 and signs[1] == 0.0 and 0.05 < signs[2] < 0.95):
        raise RuntimeError(f"the cameras do not cover rising, falling and mixed rays: {signs}")

    # a lit scene: refused by the fast entry points, rendered by the plain path
    lit_scene = flagship(64, "K4", ab_aliased=False)
    lit_opts = lit_scene.options(96, 64)
    refused = []
    for call in (lambda: bricks.render_forward_bricked_fast(lit_scene, lit_opts,
                                                            mesh=make_mesh(BRICKS)),
                 lambda: bricks.voxel_grads_bricked_fast(lit_scene, lit_opts,
                                                         cotangent(64, 96, seed=20),
                                                         mesh=make_mesh(BRICKS))):
        try:
            call()
        except NotImplementedError as exc:
            refused.append(str(exc))
    if len(refused) != 2:
        raise RuntimeError("a fast brick entry point took a lit scene")
    lit_err = check("lit plain bricked render",
                    bricks.render_forward_bricked(lit_scene, lit_opts, mesh=make_mesh(BRICKS)),
                    render_forward_fast(lit_scene, lit_opts), *tol["K4"], None)
    record({"phase": "bricks_vs_plain", "volume": COMPARE["volume"],
            "image": [COMPARE["width"], COMPARE["height"]], "bricks": BRICKS, "volume_noise": 0.05,
            "tolerance": {"atol": tol["K1"][0], "rtol": tol["K1"][1],
                          "gradients_of_scale": BRICK_GRAD_TOL},
            "cases": bricks_cases,
            "lit": {"refused_by_fast_entry_points": True,
                    "plain_bricked_vs_K4_kernel_max_abs_err": lit_err, "volume": 64,
                    "image": [96, 64]}})
    del lit_scene

    # ---- 9. the z-brick main path at 256^3 / 512^2 ------------------------
    scene = brick_scene(MAIN["volume"], (125, 25, 0))      # the noisy K3 scene
    dense = brick_scene(MAIN["volume"], (125, 25, 0), factor_absorption=4.0,
                        opacity_threshold=0.3)
    opts = scene.options(size, size)
    single = render_forward_fast(scene, opts)
    single_dense_steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
    single_dense = render_forward_fast(dense, opts, steps=single_dense_steps)
    splits = {n: bricks.split_bricks(scene, make_mesh(n)) for n in (BRICKS, 2 * BRICKS)}
    dense_splits = {n: bricks.split_bricks(dense, make_mesh(n)) for n in (BRICKS, 2 * BRICKS)}
    # the first training step's state, whole and cut
    params, static_scene = train.split_params(scene)
    bparams, bstatic = bricks.split_params_bricked(scene, make_mesh(BRICKS))
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
        for p in bparams["emission"]:
            p.mul_(1.3).add_(0.05)
    with torch.no_grad():
        merged = train.merge_params(params, static_scene)
        img0 = render_forward_fast(merged, opts)
        g0 = 2.0 * (img0 - single)
        _, want_grads = voxel_grads_fast(merged, opts, g0, image=img0)
        main_compare = bricks_compare("main shapes", merged, opts, g0, band=BAND)
        main_compare.pop("image")
    boptimizer = torch.optim.Adam(bricks.param_leaves(bparams), lr=TRAIN_LR["K3"])
    bmerged = bricks.merge_params_bricked(bparams, bstatic)

    torch.cuda.synchronize()
    cuda_march.reset_launch_counts()
    brick_images = {n: bricks.render_forward_bricked_fast(split, opts)
                    for n, split in splits.items()}
    dense_images = {n: bricks.render_forward_bricked_fast(split, opts)
                    for n, split in dense_splits.items()}
    render_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    img_b, got_grads = bricks.voxel_grads_bricked_fast(bmerged, opts, g0)
    grads_launches = dict(cuda_march.LAUNCHES_BY_MODE)
    brick_losses = [
        float(bricks.train_step_fast_bricked(bparams, boptimizer, bstatic, opts, single))
        for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    brick_launches = {form: cuda_march.LAUNCHES_BY_MODE[f"K7_{form}"] for form in K7_FORMS}
    other = {k: v for k, v in cuda_march.LAUNCHES_BY_MODE.items() if not k.startswith("K7") and v}
    renders = 2 * (BRICKS + 2 * BRICKS)
    expected = {"transmittance": renders + BRICKS + TRAIN_STEPS * BRICKS,
                "segment": renders + BRICKS + TRAIN_STEPS * BRICKS,
                "scatter": BRICKS + TRAIN_STEPS * BRICKS}
    if (brick_launches != expected or other
            or render_launches["K7_transmittance"] != renders
            or render_launches["K7_segment"] != renders or render_launches["K7_scatter"] != 0
            or grads_launches["K7_scatter"] != BRICKS):
        raise RuntimeError(f"the brick main path launched {brick_launches} (others {other}), "
                           f"expected {expected}")
    if not (all(np.isfinite(brick_losses))
            and all(b < a for a, b in zip(brick_losses, brick_losses[1:]))):
        raise RuntimeError(f"the bricked loss did not fall: {brick_losses}")
    main_images = {f"{n}_bricks": image_tolerance(f"main path {n} bricks", img, single)
                   for n, img in brick_images.items()}
    for n, img in dense_images.items():
        main_images[f"dense_threshold_0.3_{n}_bricks"] = image_tolerance(
            f"main path dense {n} bricks", img, single_dense)
    main_images["dense_threshold_0.3_samples_per_ray"] = (
        float(single_dense_steps.sum()) / (size * size))
    main_images["first_step"] = image_tolerance("main path first step", img_b, img0)
    first_step_errs = check_grads(
        "bricked first step", {k: bricks.assemble(v) if isinstance(v, list) else v
                               for k, v in got_grads.items()}, want_grads, None,
        keys=want_grads.keys())
    if max(first_step_errs.values()) > BRICK_GRAD_TOL:
        raise RuntimeError(f"bricked and single-device gradients differ: {first_step_errs}")
    record({"phase": "bricks_main_path",
            "entry": ["render_forward_bricked_fast", "voxel_grads_bricked_fast",
                      "train_step_fast_bricked"],
            "volume": MAIN["volume"], "image": size, "bricks": [BRICKS, 2 * BRICKS],
            "volume_noise": 0.05, "launches": brick_launches, "expected_launches": expected,
            "vs_single_device_kernel": main_images,
            "first_step_grads_vs_voxel_grads_fast_of_scale": first_step_errs,
            "tolerance_of_scale": BRICK_GRAD_TOL, "steps": TRAIN_STEPS, "optimizer": "Adam",
            "lr": TRAIN_LR["K3"], "losses": brick_losses,
            "kernels_vs_plain_band": main_compare})
    del splits, dense_splits, dense, brick_images, dense_images, single_dense, bmerged, got_grads
    del want_grads, img_b
    torch.cuda.empty_cache()

    # ---- 10. timing the z-brick path with 4 bricks at 256^3 / 512^2 -------
    def brick_state(split, g):
        """The inputs of every brick's launch forms: phase 1's forward, and
        per brick w_in, up_dot and the entry record, made once outside the
        timed calls."""
        fwd = bricks._forward(split, opts, 0.0, fast=True)
        up_dots = [u.contiguous() for u in bricks._upstream(
            [brick_march.own_dot(g, own) for own in fwd.own], fwd.ascending, torch.cumsum, 0.0)]
        return fwd, [w.contiguous() for w in fwd.w_in], up_dots

    def time_forms(split, g, fwd, w_ins, up_dots):
        """Each launch form over all bricks (CUDA events, warm, median of 5),
        and the samples each form took."""
        samples = {"transmittance": 0, "segment": 0}
        for brick, w_in, entry in zip(split.bricks, w_ins, fwd.entry):
            steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
            cuda_bricks.brick_transmittance(brick, opts, steps=steps)
            samples["transmittance"] += int(steps.sum())
            cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry, steps=steps)
            samples["segment"] += int(steps.sum())
        samples["scatter"] = samples["segment"]  # g is nonzero on every ray that marches
        form_ms = {
            "transmittance": median_ms(lambda: [cuda_bricks.brick_transmittance(b, opts)
                                                for b in split.bricks]),
            "segment": median_ms(lambda: [cuda_bricks.brick_segment(b, opts, 0.0, w, e)
                                          for b, w, e in zip(split.bricks, w_ins, fwd.entry)]),
            "scatter": median_ms(lambda: [
                cuda_bricks.brick_gradients(b, opts, 0.0, g, fwd.image, w, u, e)
                for b, w, u, e in zip(split.bricks, w_ins, up_dots, fwd.entry)]),
        }
        return samples, form_ms

    def carried_adds(split, w_ins, fwd):
        """The gradient segment's atomic adds a sample over all bricks, from
        the plain walk's positions (corner_flushes): both grids are carried
        where absorption has emission's shape."""
        samples = flushes = 0
        for brick, w_in, entry in zip(split.bricks, w_ins, fwd.entry):
            n, f = corner_flushes(brick, opts, w_in, entry)
            samples, flushes = samples + n, flushes + f
        grids = 1 + (not split.bricks[0].scene.absorption_aliased)
        return {"samples": samples, "flushes_per_grid": flushes,
                "atomic_adds_per_sample": grids * flushes / samples,
                "atomic_adds_per_sample_uncarried": 8 * grids}

    pixels = size * size * 4

    def form_cells(split, samples, form_ms, plain):
        grid_bytes = {"em": sum(b.scene.emission.data.numel() * 4 for b in split.bricks),
                      "ab": sum(b.scene.absorption.data.numel() * 4 for b in split.bricks)}
        # each brick reads its padded grids once and its per-ray planes (the
        # entry record 5 floats) once, and writes its own outputs once
        form_bytes = {
            "transmittance": grid_bytes["ab"] + BRICKS * pixels * (1 + 5),
            "segment": grid_bytes["em"] + grid_bytes["ab"] + BRICKS * pixels * (5 + 1 + 3 + 1),
            "scatter": (2 * (grid_bytes["em"] + grid_bytes["ab"])
                        + BRICKS * pixels * (5 + 3 + 3 + 1 + 1 + 2)),
        }
        # the operation counts fetch absorption at the emission's corners
        assert all(b.scene.absorption.data.shape == b.scene.emission.data.shape
                   for b in split.bricks)
        out = {}
        for form in K7_FORMS:
            flops = samples[form] * brick_flops_per_sample(form, ab_aliased=False)
            bound = {"bytes": form_bytes[form] / PEAK_BYTES_PER_S * 1e3,
                     "operations": flops / PEAK_FP32_FLOPS * 1e3}
            bound_by = max(bound, key=bound.get)
            out[form] = {
                "ms": form_ms[form][0], "ms_all": form_ms[form][1], "launches_timed": BRICKS,
                "samples": samples[form], "flops": flops, "bytes": form_bytes[form],
                "bound_ms": bound[bound_by], "bound_by": bound_by}
            if plain is not None:
                out[form].update(plain_ms=plain["plain_ms"][form], plain_rows=plain["plain_rows"])
        return out

    with torch.no_grad():
        for key, value in bparams.items():  # both sides time the same state
            params[key].copy_(bricks.assemble(value) if isinstance(value, list) else value)
        split = bricks.merge_params_bricked(bparams, bstatic)
        merged = train.merge_params(params, static_scene)
        g = 2.0 * (bricks._forward(split, opts, 0.0, fast=True).image - single)
        fwd, w_ins, up_dots = brick_state(split, g)
        samples, form_ms = time_forms(split, g, fwd, w_ins, up_dots)
        adds = carried_adds(split, w_ins, fwd)
        single_steps = torch.zeros((size, size), dtype=torch.int32, device=dev)
        render_forward_fast(merged, opts, steps=single_steps)
        path_ms = {
            "bricked_forward": median_ms(lambda: bricks.render_forward_bricked_fast(split, opts)),
            "bricked_fwd_bwd": median_ms(lambda: bricks.voxel_grads_bricked_fast(split, opts, g)),
            "single_forward_K1": median_ms(lambda: render_forward_fast(merged, opts)),
            "single_fwd_bwd_K1_K3": median_ms(lambda: voxel_grads_fast(merged, opts, g)),
        }
    path_ms["bricked_train_step"] = median_ms(lambda: bricks.train_step_fast_bricked(
        bparams, boptimizer, bstatic, opts, single))
    optimizer = torch.optim.Adam(list(params.values()), lr=TRAIN_LR["K3"])
    path_ms["single_train_step"] = median_ms(lambda: train.train_step_fast(
        params, optimizer, static_scene, opts, single))
    brick_cells = form_cells(split, samples, form_ms, main_compare)
    brick_cells["scatter"]["atomic_adds"] = adds

    # the dense scene: rays die mid-volume, so the walk to a brick is a
    # larger share of a ray's work
    dense = brick_scene(MAIN["volume"], (125, 25, 0), factor_absorption=4.0,
                        opacity_threshold=0.3)
    with torch.no_grad():
        dense_split = bricks.split_bricks(dense, make_mesh(BRICKS))
        g_dense = cotangent(size, size, seed=30)
        dense_fwd, dense_w_ins, dense_up = brick_state(dense_split, g_dense)
        dense_samples, dense_ms = time_forms(dense_split, g_dense, dense_fwd, dense_w_ins,
                                             dense_up)
        dense_cells = form_cells(dense_split, dense_samples, dense_ms, None)
        dense_forward = median_ms(lambda: bricks.render_forward_bricked_fast(dense_split, opts))
        dense_single = median_ms(lambda: render_forward_fast(dense, opts))
    record({"phase": "bricks_timing", "volume": MAIN["volume"], "image": size, "bricks": BRICKS,
            "single_device_samples": int(single_steps.sum()),
            "forms": brick_cells,
            "paths_ms": {k: v[0] for k, v in path_ms.items()},
            "paths_ms_all": {k: v[1] for k, v in path_ms.items()},
            "dense_threshold_0.3": {"forms": dense_cells,
                                    "paths_ms": {"bricked_forward": dense_forward[0],
                                                 "single_forward_K1": dense_single[0]},
                                    "paths_ms_all": {"bricked_forward": dense_forward[1],
                                                     "single_forward_K1": dense_single[1]}}})
    del split, merged, fwd, params, bparams, bstatic, static_scene, optimizer, boptimizer
    del dense, dense_split, dense_fwd
    torch.cuda.empty_cache()

    # ---- 11. another version's K1-K4, K6 and K7 against the checkout's -----
    if args.parent:
        t_phase = time.perf_counter()
        turns = {"parent": [], "new": []}
        # one process a version, started once; each runs a turn when asked,
        # so only one of them uses the card at a time
        procs = {who: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--turn", "--repo",
             os.path.abspath(args.parent if who == "parent" else args.repo)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for who in turns}

        def read_until(who, phase):
            seen = []
            for line in procs[who].stdout:
                seen.append(line)
                if line.startswith('{"phase": "%s"' % phase):
                    return json.loads(line)
            raise RuntimeError(f"the {who} turn failed:\n{''.join(seen)[-8000:]}")

        try:
            for who in procs:  # both built and idle before the first turn
                read_until(who, "ready")
            for who in ("parent", "new", "new", "parent"):
                procs[who].stdin.write("turn\n")
                procs[who].stdin.flush()
                turns[who].append(read_until(who, "turn"))
            for proc in procs.values():
                proc.stdin.close()
                proc.wait(timeout=120)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

        def compare_turns(get, bound_ms):
            parent_ms = [get(t) for t in turns["parent"]]
            new_ms = [get(t) for t in turns["new"]]
            return {"parent_ms": parent_ms, "ms": new_ms, "parent_mean_ms": float(np.mean(parent_ms)),
                    "mean_ms": float(np.mean(new_ms)), "bound_ms": bound_ms}

        every = turns["parent"] + turns["new"]
        compared = {}
        grads = ("backward_ms", "fwd_bwd_ms", "train_step_ms")
        for key, metrics in (("K1_256_512", ("ms",)), ("K1_512_1024", ("ms",)),
                             ("K4_256_512", ("ms",)), ("K4_512_1024", ("ms",)),
                             ("K3_256_512", grads), ("K6_256_512", grads)):
            compared[key] = {metric: compare_turns(lambda t: t["march"][key][metric],
                                                   cells[key]["bound_ms"])
                             for metric in metrics}
            if metrics == ("ms",):
                # K1 and K4 change only the order of their loads, never the
                # arithmetic: one image in both versions
                if len({t["march"][key]["image_sha1"] for t in every}) != 1:
                    raise RuntimeError(f"{key}: the parent's image differs from the checkout's")
                compared[key]["images_equal"] = True
        # phase 2 keeps its arithmetic: one bricked image, one exit opacity
        for name in ("image_sha1", "w_out_sha1"):
            if len({t["bricks"][name] for t in every}) != 1:
                raise RuntimeError(f"K7: the parent's {name[:-5]} differs from the checkout's")
        compared[f"K7_{MAIN['volume']}_{MAIN['image']}_{BRICKS}_bricks"] = {
            "images_and_exit_opacities_equal": True,
            **{metric: compare_turns(lambda t: t["bricks"]["ms"][metric],
                                     brick_cells[metric]["bound_ms"] if metric in brick_cells
                                     else None)
               for metric in turns["new"][0]["bricks"]["ms"]}}
        record({"phase": "parent_vs_new", "parent": args.parent, "order": "parent, new, new, parent",
                "reps": 5,
                "parent_ptxas": {**turns["parent"][0]["march"]["ptxas"],
                                 **turns["parent"][0]["bricks"]["ptxas"]},
                "turn_seconds": {who: [t["seconds"] for t in ts] for who, ts in turns.items()},
                "cells": compared, "seconds": time.perf_counter() - t_phase})

    # ---- kernels line and the result ------------------------------------
    kernels = []
    for mode, what in (("K1", "unlit"), ("K4", "lit, on-the-fly gradients"),
                       ("K5", "lit, lookup gradients")):
        cell = cells[f"{mode}_{MAIN['volume']}_{MAIN['image']}"]
        kernels.append({
            "name": f"march_fwd[{mode}]", "route": "cuda",
            "source": "volume_renderer_tpu_torch/csrc/march_fwd.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": launches[mode], "max_abs_err": max_err[mode],
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "bound_ms": cell["bound_ms"],
            "bound_by": cell["bound_by"], "library_ms": None,
            "mode": what, "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image",
            "ms_big": cells.get(f"{mode}_{BIG['volume']}_{BIG['image']}", {}).get("ms"),
        })
    for mode, what in (("K2", "transfer-parameter replay"), ("K3", "voxel-gradient scatter"),
                       ("K6", "lit voxel-gradient scatter")):
        cell = cells[f"{mode}_{MAIN['volume']}_{MAIN['image']}"]
        kernels.append({
            "name": f"march_bwd[{mode}]", "route": "cuda",
            "source": "volume_renderer_tpu_torch/csrc/march_bwd.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": train_launches[mode], "max_abs_err": grad_abs_err[mode],
            "max_err_of_scale": grad_err[mode],
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "plain_rows": cell["plain_rows"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": None,
            "fwd_bwd_ms": cell["fwd_bwd_ms"], "mode": what,
            **({"atomic_adds_per_sample": cell["atomic_adds"]["atomic_adds_per_sample"]}
               if "atomic_adds" in cell else {}),
            "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image",
            "ms_big": cells.get(f"{mode}_{BIG['volume']}_{BIG['image']}", {}).get("ms"),
        })
    for form, source, what in (
            ("transmittance", "brick_fwd", "z-brick phase 1: opacity of the brick's own samples"),
            ("segment", "brick_fwd", "z-brick phase 2: shaded segment from the entry opacity"),
            ("scatter", "brick_bwd", "z-brick gradient segment with the scatter")):
        cell = brick_cells[form]
        kernels.append({
            "name": f"{source}[K7 {form}]", "route": "cuda",
            "source": f"volume_renderer_tpu_torch/csrc/{source}.cu",
            "replaces": "volume_renderer_tpu/ops/pallas_march.py:688",
            "launches": brick_launches[form], "max_abs_err": brick_err[form],
            **({"max_err_of_scale": brick_grad_err[0]} if form == "scatter" else {}),
            "ms": cell["ms"], "plain_ms": cell["plain_ms"], "plain_rows": cell["plain_rows"],
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"], "library_ms": None,
            "mode": what,
            "cell": f"{MAIN['volume']}^3 volume, {MAIN['image']}^2 image, {BRICKS} bricks "
                    f"(ms over all bricks)",
        })
    for name, cell in cells.items():
        if "finite" in cell and not (cell["finite"] and cell["nonzero_frac"] > 0.05):
            raise RuntimeError(f"cell {name} rendered nothing useful: {cell}")
    record({"kernels": kernels})
    if args.out:
        with open(args.out, "w") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
