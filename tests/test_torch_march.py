"""The port's forward march against the JAX package's plain path
(``ops.forward.render_forward``, which the JAX package's own kernel tests
hold its Pallas kernel against), and the kernel wrapper's CPU behaviour."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.forward import render_forward as jax_render_forward

import chip_smoke
from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops import cuda_march
from volume_renderer_tpu_torch.ops.forward import render_forward, render_rows

torch.set_num_threads(1)

W, H = 40, 30

# Same formulas in the same order on both sides; the remaining differences
# are torch's and XLA's float32 exp/acos/rsqrt. Measured max abs error
# 1.3e-7 (lit, reflection aliased) on images of max 0.056.
ATOL, RTOL = 1e-6, 1e-5

CASES = {
    "unlit_aliased": dict(alias_absorption=True),
    "unlit_separate": dict(),
    "lit_otf_1_light": dict(lighting=True),
    "lit_otf_2_lights": dict(lighting=True, n_lights=2, rotate=(200.0, 40.0, -30.0)),
    "lit_otf_reflection_aliased": dict(lighting=True, alias_reflection=True,
                                       alias_absorption=True),
    "lit_lookup": dict(lighting=True, gradient_volumes=True, factors=(1.2, 0.5, 0.7)),
    "non_cubic_scaled": dict(vol_shape=(12, 26, 18), element_size_um=(1.0, 0.8, 1.7),
                             lighting=True),
    # the two scenes chip_smoke.py holds the lit kernels on: y taps 1.33 voxels
    # out (a far axis of the shared tap fetch), z taps 0.56 (near); and a
    # camera near the z axis, whose rays run along faces and edges
    "lit_anisotropic_36x24x64": dict(vol_shape=(36, 24, 64), element_size_um=(1.0, 1.0, 1.6),
                                     lighting=True, rotate=(70.0, 20.0, 5.0)),
    "lit_faces_and_edges_48": dict(vol_shape=(48, 48, 48), lighting=True, rotate=(3.0, 2.0, 0.0)),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("camera_x_offset", [0.0, 0.25])
def test_render_forward_matches_jax(name, camera_x_offset):
    jscene, tscene = make_scenes(**CASES[name])
    want = np.asarray(jax_render_forward(jscene, jscene.options(W, H), camera_x_offset))
    got = render_forward(tscene, tscene.options(W, H), camera_x_offset)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    assert np.count_nonzero(want) > W * H  # the scene is in view
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_opacity_threshold_early_exit_matches_jax():
    jscene, tscene = make_scenes(factors=(1.0, 0.4, 40.0), opacity_threshold=0.5)
    want = np.asarray(jax_render_forward(jscene, jscene.options(W, H)))
    steps = torch.zeros((H, W), dtype=torch.int32)
    got = render_rows(tscene, tscene.options(W, H), 0.0, 0, H, steps=steps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the threshold cuts rays short of the box
    opts = tscene.options(W, H)
    assert 0 < int(steps.max()) < opts.n_steps - 2


@pytest.mark.parametrize("y_offset,n_rows", [(0, 7), (11, 8), (22, 8)])
def test_render_rows_band_is_slice_of_full_image(y_offset, n_rows):
    _, tscene = make_scenes(lighting=True)
    opts = tscene.options(W, H)
    full = render_forward(tscene, opts, 0.125)
    band = render_rows(tscene, opts, 0.125, y_offset, n_rows)
    np.testing.assert_array_equal(band.numpy(), full[y_offset:y_offset + n_rows].numpy())


@pytest.mark.parametrize("name", ["unlit_separate", "lit_otf_1_light", "lit_lookup"])
def test_render_forward_fast_on_cpu_is_plain_version(name):
    _, tscene = make_scenes(**CASES[name])
    opts = tscene.options(W, H)
    before = cuda_march.LAUNCHES
    steps = torch.zeros((H, W), dtype=torch.int32)
    got = cuda_march.render_forward_fast(tscene, opts, 0.25, steps=steps)
    assert cuda_march.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), render_forward(tscene, opts, 0.25).numpy())
    assert int(steps.sum()) > 0 and int(steps.max()) <= opts.n_steps


def test_kernel_mode():
    assert cuda_march.kernel_mode(make_scenes()[1]) == "K1"
    assert cuda_march.kernel_mode(make_scenes(lighting=True)[1]) == "K4"
    assert cuda_march.kernel_mode(make_scenes(lighting=True, gradient_volumes=True)[1]) == "K5"


def test_render_forward_fast_refuses_other_devices():
    _, tscene = make_scenes()
    meta = tscene.replace(emission=tscene.emission.replace(data=tscene.emission.data.to("meta")))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_march.render_forward_fast(meta, tscene.options(W, H))



# ---- the counts chip_smoke.py reports for K3 and K1 ---------------------------


def brute_force_march_flushes(scene, opts, dims):
    """The corner carry's atomic adds into one grid of ``dims`` (x, y, z), ray
    by ray in plain Python: each ray's samples at its first position plus k
    accumulated steps for k below its sample count, their cells, then 8
    minus the corners two consecutive cells share, and 8 for the last."""
    consts, pos, step, steps = chip_smoke.march_samples(scene, opts)
    bmin, bs = consts.boxmin, consts.boxscale
    flushes = 0
    for r in range(steps.numel()):
        p = [pos.x[r], pos.y[r], pos.z[r]]
        cells = []
        for _ in range(int(steps[r])):
            s = [(c - lo) * k for c, lo, k in zip(p, bmin, bs)]
            cells.append(tuple(int(torch.clamp(torch.floor(c * float(n) - 0.5), -1.0, float(n)))
                               for c, n in zip(s, dims)))
            p = [c + d for c, d in zip(p, (step.x[r], step.y[r], step.z[r]))]
        for a, b in zip(cells, cells[1:]):
            d = [abs(i - j) for i, j in zip(a, b)]
            flushes += 8 - (int(np.prod([2 - k for k in d])) if max(d) <= 1 else 0)
        flushes += 8 if cells else 0
    return int(steps.sum()), flushes


# scene arguments, and the samples and atomic adds by grid of K3's corner
# carry, on a 16^3 scene at 24x20; rays stop at the threshold in the last
MARCH_FLUSH_CASES = {
    "absorption_aliased": (dict(alias_absorption=True), (15020, {"emission": 16662})),
    "absorption_separate": (dict(), (15020, {"emission": 16662, "absorption": 16662})),
    "absorption_other_shape": (dict(), (15020, {"emission": 16662, "absorption": 12688})),
    "low_threshold": (dict(factors=(3.0, 0.4, 4.0), opacity_threshold=0.3),
                      (3132, {"emission": 4793, "absorption": 4793})),
}


@pytest.mark.parametrize("name", list(MARCH_FLUSH_CASES))
def test_march_flush_count(name):
    """``chip_smoke.march_flushes`` counts K3's atomic adds from the plain
    march: equal to a count ray by ray for each grid, the stated numbers,
    and under a quarter of the 8 a sample and grid of a scatter without the
    carry."""
    scene_kw, stated = MARCH_FLUSH_CASES[name]
    _, scene = make_scenes(vol_shape=(16, 16, 16), **scene_kw)
    if name == "absorption_other_shape":
        ab = scene.absorption.data[:, ::2, 1::3].contiguous()
        scene = scene.replace(absorption=scene.absorption.replace(data=ab))
    opts = scene.options(24, 20)
    samples, flushes = chip_smoke.march_flushes(scene, opts)
    grids = {"emission": scene.emission.data}
    if not scene.absorption_aliased:
        grids["absorption"] = scene.absorption.data
    assert set(flushes) == set(grids)
    for grid, data in grids.items():
        dims = (data.shape[2], data.shape[1], data.shape[0])
        assert brute_force_march_flushes(scene, opts, dims) == (samples, flushes[grid])
    assert (samples, flushes) == stated
    assert 0 < sum(flushes.values()) < 2 * len(flushes) * samples


def test_sector_counts_of_one_warp():
    """The gather model on one warp load instruction whose 32 lanes load a
    block of voxels of a 16^3 volume, counted by hand. x-linear: a sector is
    8 floats of one (y, z) row, a line 32 floats, two rows. Tiled 4x4x2: a
    line holds a 4x4x2 brick, a sector 4x2x1 of it."""
    def lanes(bx, by, bz, origin=(0, 0, 0)):
        z, y, x = torch.meshgrid(torch.arange(bz), torch.arange(by), torch.arange(bx),
                                 indexing="ij")
        return [(t.reshape(1, -1) + o) for t, o in zip((x, y, z), origin)]

    dims = (16, 16, 16)
    everyone = torch.ones((1, 32), dtype=torch.bool)
    # 8 x 4 x 1: four rows of 8 floats, one sector each, two rows a line;
    # two bricks, two sectors (y 0-1, y 2-3) each
    assert chip_smoke.sector_counts(*lanes(8, 4, 1), everyone, dims) == {
        "linear": (4, 2), "tiled": (4, 2)}
    # 4 x 4 x 2: eight rows, eight sectors; rows y 0-1 and y 2-3 of each z in
    # a line; one brick, its four sectors
    assert chip_smoke.sector_counts(*lanes(4, 4, 2), everyone, dims) == {
        "linear": (8, 4), "tiled": (4, 1)}
    # 32 x 1 x 1 from x = 4: sectors 4-7, 8-15, 16-23, 24-31, 32-35; lines
    # 0-31, 32-63; the bricks of x 4-7, ..., 32-35, the sector y 0-1 of each
    assert chip_smoke.sector_counts(*lanes(32, 1, 1, (4, 0, 0)), everyone, (64, 16, 16)) == {
        "linear": (5, 2), "tiled": (8, 8)}
    # lanes that do not load touch nothing: the first row of 4 x 4 x 2 alone
    first_row = torch.arange(32)[None] < 4
    assert chip_smoke.sector_counts(*lanes(4, 4, 2), first_row, dims) == {
        "linear": (1, 1), "tiled": (1, 1)}
    assert chip_smoke.sector_counts(*lanes(4, 4, 2), ~everyone, dims) == {
        "linear": (0, 0), "tiled": (0, 0)}


@pytest.mark.parametrize("warp_cols", [16, 8, 4])
def test_warp_lanes_tile_the_block(warp_cols):
    """Each warp of K1's 16x16 block covers warp_cols x 32 / warp_cols pixels,
    the 8 warps tile the block, and 16 columns is threadIdx order (16x2)."""
    lanes = chip_smoke.warp_lanes(32, 16, warp_cols)
    assert lanes.shape == (16, 32)
    assert sorted(lanes.reshape(-1).tolist()) == list(range(32 * 16))
    x, y = lanes % 32, lanes // 32
    assert ((x.amax(1) - x.amin(1)) == warp_cols - 1).all()
    assert ((y.amax(1) - y.amin(1)) == 32 // warp_cols - 1).all()
    if warp_cols == 16:
        t = torch.arange(256)
        assert torch.equal(lanes[:8].reshape(-1), (t // 16) * 32 + t % 16)


def test_gather_footprint_counts_every_load():
    """On a small scene: every warp step with a sample issues 8 corner loads,
    each touches at least one sector and at most 32, a line holds 4 sectors."""
    _, scene = make_scenes(vol_shape=(16, 16, 16))
    opts = scene.options(32, 32)
    out = chip_smoke.gather_footprint(scene, opts, 16, 16)
    assert out["samples"] > 0
    for c in (16, 8, 4):
        shape = out[f"warp_{c}x{32 // c}"]
        n = shape["instructions"]
        assert n > 0 and n % 8 == 0
        for layout in ("linear", "tiled"):
            sectors, lines = shape[layout]["sectors"], shape[layout]["lines"]
            assert n <= lines <= sectors <= 4 * lines and sectors <= 32 * n
