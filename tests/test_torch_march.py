"""The port's forward march against the JAX package's plain path
(``ops.forward.render_forward``, which the JAX package's own kernel tests
hold its Pallas kernel against), and the kernel wrapper's CPU behaviour."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.forward import render_forward as jax_render_forward

import chip_smoke
from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops import _build, cuda_grads, cuda_march
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
    before = sum(cuda_march.LAUNCHES_BY_MODE.values())
    steps = torch.zeros((H, W), dtype=torch.int32)
    got = cuda_march.render_forward_fast(tscene, opts, 0.25, steps=steps)
    assert sum(cuda_march.LAUNCHES_BY_MODE.values()) == before
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


def test_sector_counts_of_wider_elements():
    """The gather model with 8- and 16-byte voxels (a float2 or a float4 of
    packed volumes), counted by hand on the blocks of the test above. A
    16-byte row of 8 voxels from x = 0 is 128 bytes: 4 sectors, 1 line."""
    def lanes(bx, by, bz, origin=(0, 0, 0)):
        z, y, x = torch.meshgrid(torch.arange(bz), torch.arange(by), torch.arange(bx),
                                 indexing="ij")
        return [(t.reshape(1, -1) + o) for t, o in zip((x, y, z), origin)]

    dims = (16, 16, 16)
    everyone = torch.ones((1, 32), dtype=torch.bool)
    # 8 x 4 x 1 of float4: four rows of 128 bytes; tiled, the two 4x4x2
    # tiles (512 bytes each) give their z = 0 halves, 256 bytes: 8 sectors,
    # 2 lines each. Four float32 loads of it touch 16 sectors and 8 lines.
    assert chip_smoke.sector_counts(*lanes(8, 4, 1), everyone, dims, elem=16) == {
        "linear": (16, 4), "tiled": (16, 4)}
    # float2: rows of 64 bytes, a 16-voxel row of the volume is one line
    assert chip_smoke.sector_counts(*lanes(8, 4, 1), everyone, dims, elem=8) == {
        "linear": (8, 4), "tiled": (8, 2)}
    # 32 x 1 x 1 of float4 from x = 4: bytes 64-575, sectors 2-17, lines
    # 0-4; tiled, 8 tiles of one 64-byte row each
    assert chip_smoke.sector_counts(*lanes(32, 1, 1, (4, 0, 0)), everyone, (64, 16, 16),
                                    elem=16) == {"linear": (16, 5), "tiled": (16, 8)}
    # elem=4 is the float32 count
    assert chip_smoke.sector_counts(*lanes(8, 4, 1), everyone, dims, elem=4) == \
        chip_smoke.sector_counts(*lanes(8, 4, 1), everyone, dims)


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


def test_gather_footprint_of_packed_corners():
    """The gather model of K5's float4 corner loads beside the float32 ones
    of the same positions: the same instructions, each touching at least
    the sectors and lines of a float32 load and at most four times its
    sectors (four float32 loads of the packed volumes)."""
    _, scene = make_scenes(vol_shape=(16, 16, 16), lighting=True, gradient_volumes=True)
    opts = scene.options(32, 32)
    out = chip_smoke.gather_footprint(scene, opts, 8, 16, warp_cols=(16,), elems=(4, 16))
    one, packed = out["warp_16x2"], out["warp_16x2_16B"]
    assert one["instructions"] == packed["instructions"] > 0
    for layout in ("linear", "tiled"):
        s1, l1 = one[layout]["sectors"], one[layout]["lines"]
        s4, l4 = packed[layout]["sectors"], packed[layout]["lines"]
        assert s1 <= s4 <= 4 * s1 and l1 <= l4 <= 4 * l1 and l4 <= s4 <= 4 * l4


def test_pack_lookup_holds_the_four_volumes():
    """K5's packed grid: channels emission, gradient_x, gradient_y,
    gradient_z, bit for bit, one contiguous (D, H, W, 4) float32 tensor;
    none where a gradient volume has another shape."""
    _, scene = make_scenes(vol_shape=(12, 10, 14), lighting=True, gradient_volumes=True)
    packed = cuda_march.pack_lookup(scene)
    assert packed.shape == (12, 10, 14, 4) and packed.dtype == torch.float32
    assert packed.is_contiguous()
    for c, vol in enumerate((scene.emission, scene.gradient_x, scene.gradient_y,
                             scene.gradient_z)):
        assert torch.equal(packed[..., c], vol.data)
    # the three gradient volumes differ from each other and from emission
    assert len({packed[..., c].numpy().tobytes() for c in range(4)}) == 4
    small = scene.gradient_y.replace(data=scene.gradient_y.data[:, ::2].contiguous())
    assert cuda_march.pack_lookup(scene.replace(gradient_y=small)) is None


def test_pack_pair_holds_the_two_volumes():
    """Unlit K2's packed grid: channels emission and absorption, bit for bit,
    one contiguous (D, H, W, 2) float32 tensor, the same copy as
    ``torch.stack(..., dim=-1)``; none where absorption is aliased to
    emission or has another shape (the kernel then fetches each volume at its
    own cell)."""
    _, scene = make_scenes(vol_shape=(12, 10, 14))
    assert not scene.absorption_aliased
    pair = cuda_grads.pack_pair(scene)
    assert pair.shape == (12, 10, 14, 2) and pair.dtype == torch.float32
    assert pair.is_contiguous()
    assert torch.equal(pair[..., 0], scene.emission.data)
    assert torch.equal(pair[..., 1], scene.absorption.data)
    assert not torch.equal(pair[..., 0], pair[..., 1])
    assert torch.equal(pair, torch.stack([scene.emission.data, scene.absorption.data], dim=-1))
    _, aliased = make_scenes(vol_shape=(12, 10, 14), alias_absorption=True)
    assert aliased.absorption_aliased and cuda_grads.pack_pair(aliased) is None
    small = scene.absorption.replace(data=scene.absorption.data[:, ::2].contiguous())
    assert cuda_grads.pack_pair(scene.replace(absorption=small)) is None


def test_ptxas_report_by_mode():
    """chip_smoke's reading of ptxas: a kernel instantiation is keyed by its
    mode and template arguments (K5 packed has five), and its blocks an SM
    follow from its registers and its block, K7 phase 1's as
    csrc/brick_fwd.cu sets it."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112march_kernelILb1ELb1ELb0ELb0ELb1EEEv9MarchArgs' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_112march_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 0 barriers, 560 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116brick_fwd_kernelILb0ELb0EEEv9BrickArgs' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116brick_fwd_kernel",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 0 barriers, 640 bytes cmem[0]",
    ])
    threads = chip_smoke.kernel_threads(chip_smoke.REPO)
    got = chip_smoke.ptxas_by_kernel(log, threads=threads)
    assert set(got) == {"K5 march_kernel<1,1,0,0,1>", "K7_transmittance brick_fwd_kernel<0,0>"}
    k5 = got["K5 march_kernel<1,1,0,0,1>"]
    assert (k5["registers"], k5["threads"], k5["blocks_per_sm"], k5["warps_per_sm"]) == (
        80, 256, 3, 24)
    k7 = got["K7_transmittance brick_fwd_kernel<0,0>"]
    rows = int(re.search(r"constexpr int kPhase1Rows = (\d+);",
                         (_build.CSRC_DIR / "brick_fwd.cu").read_text()).group(1))
    assert k7["threads"] == threads["K7_transmittance"] == 16 * rows
    assert k7["warps_per_sm"] == chip_smoke.blocks_per_sm(56, k7["threads"]) * k7["threads"] // 32
    assert k7["spill_store_bytes"] == 0


def test_ptxas_report_of_the_k2_kernels():
    """chip_smoke's reading of ptxas for K2: the unlit kernel (absorption
    packed with emission, or aliased) and the lit one map to K2, and each
    block has 16 rows of the constant that csrc/march_bwd.cu sets for it."""
    source = (_build.CSRC_DIR / "march_bwd.cu").read_text()
    rows = {name: int(re.search(r"constexpr int %s = (\d+);" % name, source).group(1))
            for name in ("kK2Rows", "kK2LitRows")}
    instantiations = (("23march_bwd_params_kernel", "Lb0ELb1E", 40),
                      ("23march_bwd_params_kernel", "Lb1ELb0E", 32),
                      ("27march_bwd_lit_params_kernel", "Lb0ELb0E", 128))
    log = "\n".join(
        f"ptxas info    : Compiling entry function "
        f"'_ZN12_GLOBAL__N_1{kernel}I{args}EEv8GradArgs' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {registers} registers, used 0 barriers, 560 bytes cmem[0]"
        for kernel, args, registers in instantiations)
    threads = chip_smoke.kernel_threads(chip_smoke.REPO)
    assert threads["march_bwd_params_kernel"] == 16 * rows["kK2Rows"]
    assert threads["march_bwd_lit_params_kernel"] == 16 * rows["kK2LitRows"]
    got = chip_smoke.ptxas_by_kernel(log, threads=threads)
    assert set(got) == {"K2 march_bwd_params_kernel<0,1>", "K2 march_bwd_params_kernel<1,0>",
                        "K2 march_bwd_lit_params_kernel<0,0>"}
    for key, n in (("K2 march_bwd_params_kernel<0,1>", 16 * rows["kK2Rows"]),
                   ("K2 march_bwd_lit_params_kernel<0,0>", 16 * rows["kK2LitRows"])):
        info = got[key]
        assert info["threads"] == n and info["spill_store_bytes"] == 0
        assert info["warps_per_sm"] == chip_smoke.blocks_per_sm(info["registers"], n) * n // 32
