"""Lit K7 phase 2's packed window and the lit gradient segment's carry, on
the CPU: the window pack that the lit lookup form reads
(``ops.cuda_bricks.pack_window``) against ``ops.cuda_march.interleave`` of a
brick's or slab's four windows and against the rows of the whole volume's
pack; the planner's count of the pack's peak; and ``chip_smoke.py``'s
counts for the two kernels: the tail factor of a launch's blocks from its
steps plane (``tail_factor``), and the lit segment's atomic adds a sample
from the plain walk's positions (``lit_corner_flushes``: the emission tap
window and absorption's and reflection's carried corners), each against a
count by hand (the kernel's, and those of a carry of absorption's and
reflection's corners, measured and dropped). The kernels themselves run only on the card
(``chip_smoke.py`` phases 8, 10 and 11).

Scenes are 16^3 (``make_scenes``: numpy from a seed), images 24x20, 4
bricks or slabs; the lit bricked renders are held against the JAX package's
in ``test_torch_bricks.py`` and ``test_torch_lit_routes.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from volume_renderer_tpu.parallel.bricks import render_forward_bricked as jax_bricked
from volume_renderer_tpu.parallel.sharding import make_mesh as jax_make_mesh

import chip_smoke
from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.api import planner
from volume_renderer_tpu_torch.api.planner import tier_bytes
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks, cuda_march
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.brick_march import HALO
from volume_renderer_tpu_torch.ops.slab import slab_of
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOL = (16, 16, 16)
W, H = 24, 20
N = 4  # bricks or slabs


def lookup_scene(**kw):
    return make_scenes(vol_shape=VOL, lighting=True, gradient_volumes=True, **kw)[1]


def windows(kind, scene):
    """The N bricks or slabs of ``scene``."""
    if kind == "brick":
        return bricks.split_bricks(scene, make_mesh(N, "cpu")).bricks
    return [slab_of(scene, s, N) for s in range(N)]


# ---- the packed window -------------------------------------------------------


@pytest.mark.parametrize("kind", ["brick", "slab"])
@pytest.mark.parametrize("index", range(N))
def test_pack_window_is_the_windows_interleaved(kind, index):
    """A lookup brick's (or slab's) pack is its four windows interleaved,
    channels emission, gradient_x, gradient_y, gradient_z, and its rows
    inside the volume are rows [z_off, z_off + D_win) of the whole volume's
    pack (K5's): the kernel reads them placed as the emission window is."""
    scene = lookup_scene()
    part = windows(kind, scene)[index]
    pack = cuda_bricks.pack_window(part)
    s = part.scene
    grids = [s.emission.data, s.gradient_x.data, s.gradient_y.data, s.gradient_z.data]
    assert pack.is_contiguous() and tuple(pack.shape) == tuple(grids[0].shape) + (4,)
    assert torch.equal(pack, cuda_march.interleave(grids))
    for c, grid in enumerate(grids):
        assert torch.equal(pack[..., c], grid)
    z_off, d_global = part.slab_geometry(s.emission.data)
    assert d_global == VOL[0]
    whole = cuda_march.pack_lookup(scene)
    lo, hi = max(z_off, 0), min(z_off + pack.shape[0], VOL[0])
    assert hi - lo == (pack.shape[0] if kind == "slab" or 0 < index < N - 1
                       else pack.shape[0] - HALO)
    assert torch.equal(pack[lo - z_off:hi - z_off], whole[lo:hi])


@pytest.mark.parametrize("case", ["gradients_other_shape", "otf", "unlit"])
def test_pack_window_is_none_where_nothing_is_packed(case):
    """No pack where the gradient windows have another shape than emission's
    (the kernel then fetches each window on its own), nor for a scene without
    lookup gradient volumes."""
    if case == "gradients_other_shape":
        scene = lookup_scene()
        cut = {k: getattr(scene, k).replace(data=getattr(scene, k).data[:, ::2, ::2].contiguous())
               for k in ("gradient_x", "gradient_y", "gradient_z")}
        scene = scene.replace(**cut)
    else:
        scene = make_scenes(vol_shape=VOL, lighting=case == "otf")[1]
    for kind in ("brick", "slab"):
        assert all(cuda_bricks.pack_window(part) is None for part in windows(kind, scene))


@functools.lru_cache(maxsize=None)
def lookup_renders():
    """The lit lookup scene bricked through the fast entry point (phase 2's
    wrapper, the plain pass on the CPU), the JAX package's bricked render, and
    the port's single-device render."""
    jscene, tscene = make_scenes(vol_shape=VOL, lighting=True, gradient_volumes=True)
    opts = tscene.options(W, H)
    got = bricks.render_forward_bricked_fast(tscene, opts, mesh=make_mesh(N, "cpu"))
    want = np.asarray(jax_bricked(jscene, jscene.options(W, H),
                                  mesh=jax_make_mesh(N, axis_name="bricks")))
    return got.numpy(), want, cuda_march.render_forward_fast(tscene, opts).numpy()


def test_lit_lookup_bricks_match_jax_and_the_single_device_march():
    """The lit lookup brick path, whose card form now reads a packed window,
    renders what the JAX package's bricks render (its own tolerance,
    rtol=5e-4, atol=1e-5) and, on the CPU, the port's single-device image
    within 1e-7 (the same positions and fetches)."""
    got, want, single = lookup_renders()
    assert np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-7)


def test_the_planner_counts_the_packs_peak():
    """The pack is made by stacking the four grids and copying them packed:
    eight grids of its rows at its peak. The whole-grid tier counts K5's for
    the whole depth, the sweeps and the bricks lit phase 2's for a window a
    launch; a scene whose gradient volumes have another shape packs nothing."""
    scene = make_scenes(vol_shape=(64, 24, 20), lighting=True, gradient_volumes=True)[1]
    opts = scene.options(16, 12)
    plane = 24 * 20 * 4
    assert planner._pack_bytes(scene) == 8 * 64 * plane
    assert planner._pack_bytes(scene, 20) == 8 * 20 * plane
    cut = {k: getattr(scene, k).replace(data=getattr(scene, k).data[:, ::2].contiguous())
           for k in ("gradient_x", "gradient_y", "gradient_z")}
    other = scene.replace(**cut)
    assert planner._pack_bytes(other) == planner._pack_bytes(other, 20) == 0
    n = 4
    rows = 64 // n + 2 * HALO
    win = 6 * rows * plane  # emission, absorption, reflection and the three gradient windows
    lut = planner._nbytes(scene.illumination.shape)
    sweep = planner.ray_state_bytes(opts, "sweep")
    assert (tier_bytes(scene, opts, "streamed", n_slabs=n)
            == 2 * win + 8 * rows * plane + lut + sweep)
    assert (tier_bytes(scene, opts, "slabbed", n_slabs=n)
            == planner.scene_volume_bytes(scene) + 8 * rows * plane + sweep)
    assert (tier_bytes(scene, opts, "bricked", n_devices=n)
            - tier_bytes(scene.replace(**cut), opts, "bricked", n_devices=n)
            == 8 * rows * plane + 3 * rows * (plane - 12 * 20 * 4))


# ---- chip_smoke.py's tail factor -----------------------------------------------


def test_tail_factor_by_hand():
    """The tail factor of a steps plane: the blocks' threads (pixels inside
    the image) times their largest count, over the counts, counted by hand
    for a 3 x 18 plane in 16x2 blocks (warps) and 16x16 ones, for a list of
    planes (a form's launches over the bricks) and for a plane whose rays all
    take as many samples."""
    steps = torch.zeros((3, 18), dtype=torch.int32)
    steps[0, 0], steps[1, 3], steps[2, 17], steps[0, 16] = 4, 2, 6, 1
    work = 4 + 2 + 6 + 1
    # 16x2: rows 0-1 x cols 0-15 (32 threads, most 4), rows 0-1 x cols 16-17
    # (4, 1), row 2 x cols 0-15 (16, 0), row 2 x cols 16-17 (2, 6)
    assert chip_smoke.tail_factor(steps, 16, 2) == (32 * 4 + 4 * 1 + 16 * 0 + 2 * 6) / work
    # 16x16: rows 0-2 x cols 0-15 (48 threads, most 4), rows 0-2 x cols 16-17 (6, 6)
    assert chip_smoke.tail_factor(steps, 16, 16) == (48 * 4 + 6 * 6) / work
    assert chip_smoke.tail_factor([steps, steps], 16, 2) == chip_smoke.tail_factor(steps, 16, 2)
    assert chip_smoke.tail_factor(torch.full((5, 40), 7, dtype=torch.int32), 16, 4) == 1.0
    assert chip_smoke.tail_factor(torch.zeros((4, 4), dtype=torch.int32)) is None
    factors = chip_smoke.tail_factors(steps)
    assert list(factors) == ["16x16", "16x8", "16x4", "16x2"]
    assert factors["16x16"] >= factors["16x8"] >= factors["16x4"] >= factors["16x2"] >= 1.0


# ---- chip_smoke.py's atomic adds of the lit gradient segment ---------------------


def brute_force_lit_adds(brick, opts, w_in, entry):
    """(samples, tap adds, flushes a carried grid) of the lit gradient
    segment, ray by ray in plain Python from the walk's positions. Tap adds:
    at each sample the voxels (unclamped) that the centre's fetch and the
    taps of the axes sharing its window read, one add each, and 16 for the
    two taps of any other axis (an axis shares the window where the plus
    tap's lower corner is the centre's or one above and the minus tap's the
    centre's or one below). Flushes: a carry on the centre's cells, 8 minus
    the corners two consecutive cells share, and 8 for the last cell."""
    rays = brick_march.BrickRays(brick, opts, 0.0)
    consts, sample_ab = rays.consts, brick_march.brick_samplers(brick).ab
    em = brick.scene.emission.data
    dims = (em.shape[2], em.shape[1], brick.slab_geometry(em)[1])

    def lower(s):  # float32 corners, as the walk's positions are float32
        return [torch.clamp(torch.floor(c * float(d) - 0.5), -1.0, float(d)).to(torch.int64)
                for c, d in zip(s, dims)]

    seen = []

    def composite(pos, act, sw):
        s = core.to_sample_coords(pos, consts)
        taps = [lower(t) for t in core.otf_tap_positions(pos, consts)]  # xp, xm, yp, ym, zp, zm
        seen.append((act.clone(), lower(s), taps))
        ab = sample_ab(s)
        return 1.0 - torch.exp(-(consts.factor_absorption * ab) * consts.tstep)

    rays.walk(w_in, composite, entry=entry)
    samples = tap_adds = flushes = 0
    for r in range(H * W):
        cells = []
        for act, centre, taps in seen:
            if not act[r]:
                continue
            c = tuple(int(v[r]) for v in centre)
            cells.append(c)
            voxels = {(c[0] + a, c[1] + b, c[2] + e)
                      for a in (0, 1) for b in (0, 1) for e in (0, 1)}
            for axis in range(3):
                plus, minus = (tuple(int(v[r]) for v in taps[2 * axis + k]) for k in (0, 1))
                if plus[axis] - c[axis] in (0, 1) and minus[axis] - c[axis] in (-1, 0):
                    j, k = (i for i in range(3) if i != axis)
                    for tap in (plus, minus):
                        voxels |= {tuple(tap[i] + (a if i == j else b if i == k else e)
                                         for i in range(3))
                                   for a in (0, 1) for b in (0, 1) for e in (0, 1)}
                else:
                    tap_adds += 16
            tap_adds += len(voxels)
        samples += len(cells)
        for a, b in zip(cells, cells[1:]):
            d = [abs(i - j) for i, j in zip(a, b)]
            flushes += 8 - (int(np.prod([2 - k for k in d])) if max(d) <= 1 else 0)
        flushes += 8 if cells else 0
    return samples, tap_adds, flushes


# scene arguments, the grids a carry would take, and brick 1's samples, tap
# adds and flushes a carried grid (no ray reaches the threshold but at 0.3: the
# samples follow the geometry alone); absorption of another shape is cut
# from the scene's (16, 16, 16) to (16, 8, 5)
LIT_FLUSH_CASES = {
    "lit": (dict(lighting=True), 2, (3942, 78848, 5128)),
    "reflection_aliased": (dict(lighting=True, alias_reflection=True), 1, (3942, 78848, 5128)),
    "absorption_aliased": (dict(lighting=True, alias_absorption=True), 1, (3942, 78848, 5128)),
    "absorption_other_shape": (dict(lighting=True), 0, (3942, 78848, 5128)),
    "low_threshold": (dict(lighting=True, factors=(3.0, 0.4, 4.0), opacity_threshold=0.3), 2,
                      (395, 7908, 732)),
}


@pytest.mark.parametrize("name", list(LIT_FLUSH_CASES))
def test_lit_corner_flush_count(name):
    """``chip_smoke.lit_corner_flushes`` counts the lit gradient segment's
    atomic adds from the plain walk: the stated numbers, equal to a count ray
    by ray, the same walked from step 0: the tap window about 20 a sample,
    absorption and reflection 8 each unless aliased, and a carry of them
    where they have emission's shape about one a sample each."""
    scene_kw, carry, stated = LIT_FLUSH_CASES[name]
    _, scene = make_scenes(vol_shape=VOL, **scene_kw)
    if name == "absorption_other_shape":
        ab = scene.absorption.data[:, ::2, 1::3].contiguous()
        scene = scene.replace(absorption=scene.absorption.replace(data=ab))
    opts = scene.options(W, H)
    split = bricks.split_bricks(scene, make_mesh(N, "cpu"))
    fwd = bricks._forward(split, opts, 0.0, fast=False)
    brick, w_in, entry = split.bricks[1], fwd.w_in[1], fwd.entry[1]
    counted = chip_smoke.lit_corner_flushes(brick, opts, w_in, entry)
    samples, taps, flushes = stated
    assert brute_force_lit_adds(brick, opts, w_in, entry) == stated
    assert (counted["samples"], counted["tap_adds"], counted["flushes_per_grid"]) == stated
    assert counted == chip_smoke.lit_corner_flushes(brick, opts, w_in, None)  # from step 0
    assert counted["carry_grids"] == carry == chip_smoke.lit_carry_grids(brick.scene)
    roles = 2 - scene.absorption_aliased - scene.reflection_aliased
    assert counted["atomic_adds_per_sample"] == (taps + 8 * roles * samples) / samples
    assert counted["atomic_adds_per_sample_carried"] == (
        taps + carry * flushes + 8 * (roles - carry) * samples) / samples
    assert 19.0 < taps / samples < 21.0 and flushes < 2 * samples
