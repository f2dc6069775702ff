"""The port's z-brick path on the CPU against the JAX package's
(``parallel/bricks.py`` on the 8 virtual CPU devices of ``conftest.py``) and
against the port's own single-device render: the sampling primitive, the
plain bricked render, the fast entry points' CPU path (the kernels' plain
passes) and the bricked training step. The gradients are in
``test_torch_bricks_grads.py``.

Scenes are 16^3 (``make_scenes``: numpy from a seed, carried across by
``scene_from_arrays``), images at most 32^2, B = 4 and 8.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.float3 import F3 as JF3
from volume_renderer_tpu.ops.pallas_march import last_fallback_reason
from volume_renderer_tpu.ops.sampling import sample_trilinear_zslab as jax_zslab
from volume_renderer_tpu.parallel.bricks import render_forward_bricked as jax_bricked
from volume_renderer_tpu.parallel.bricks import render_forward_bricked_fast as jax_bricked_fast
from volume_renderer_tpu.parallel.sharding import make_mesh as jax_make_mesh

import chip_smoke
from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.convert import params_from_arrays
from volume_renderer_tpu_torch.models.scene import RenderOptions
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks, cuda_march
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.ops.float3 import F3
from volume_renderer_tpu_torch.ops.forward import render_forward
from volume_renderer_tpu_torch.ops.sampling import sample_trilinear, sample_trilinear_zslab
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOL = (16, 16, 16)
W, H = 24, 20

# name: (scene arguments, number of bricks)
CASES = {
    "unlit": (dict(), 8),
    "lit_otf": (dict(lighting=True), 8),
    "lit_lookup": (dict(lighting=True, gradient_volumes=True), 4),
    "lit_aliased": (dict(lighting=True, alias_absorption=True, alias_reflection=True), 8),
    "dz_negative": (dict(rotate=(180.0, 20.0, 0.0)), 8),
    "low_threshold": (dict(factors=(3.0, 0.4, 4.0), opacity_threshold=0.3), 4),
    # rays of one image with both signs of dz, crossing brick faces at grazing angles
    "grazing_mixed": (dict(rotate=(88.0, 0.0, 0.0)), 4),
}


@functools.lru_cache(maxsize=None)
def renders(name):
    """(JAX bricked, port bricked, port single-device) images of a case."""
    scene_kw, n = CASES[name]
    jscene, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    jimg = np.asarray(jax_bricked(jscene, jscene.options(W, H),
                                  mesh=jax_make_mesh(n, axis_name="bricks")))
    opts = tscene.options(W, H)
    timg = bricks.render_forward_bricked(tscene, opts, mesh=make_mesh(n, "cpu"))
    return jimg, timg.numpy(), render_forward(tscene, opts).numpy()


# ---- the sampling primitive ------------------------------------------------


@pytest.mark.parametrize("z_offset,slab_d", [(-2, 8), (2, 8), (10, 8), (0, 16)])
def test_sample_trilinear_zslab_matches_jax(z_offset, slab_d):
    rng = np.random.default_rng(3)
    full = rng.random(VOL).astype(np.float32)
    lo, hi = max(z_offset, 0), min(z_offset + slab_d, VOL[0])
    slab = np.zeros((slab_d,) + VOL[1:], np.float32)
    slab[lo - z_offset:hi - z_offset] = full[lo:hi]
    # coords whose z corners lie inside the slab, x and y also outside [0, 1]
    n = 500
    cz = (rng.uniform(lo + 1.0, hi - 1.0, n) / VOL[0]).astype(np.float32)
    cx, cy = (rng.uniform(-0.2, 1.2, n).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_zslab(jnp.asarray(slab), JF3(*(jnp.asarray(c) for c in (cx, cy, cz))),
                                z_offset, VOL[0]))
    coords = F3(*(torch.from_numpy(c) for c in (cx, cy, cz)))
    got = sample_trilinear_zslab(torch.from_numpy(slab), coords, z_offset, VOL[0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)  # measured 0.0
    # and the slab fetch is the whole volume's fetch, bit for bit
    whole = sample_trilinear(torch.from_numpy(full), coords)
    np.testing.assert_array_equal(got.numpy(), whole.numpy())


def test_zslab_clamps_z_against_the_whole_depth():
    """At the volume's faces the fetch clamps in global rows: the zero halo
    of an edge brick is never read."""
    full = torch.arange(16 * 4 * 4, dtype=torch.float32).reshape(16, 4, 4) + 1.0
    first = torch.cat([torch.zeros(2, 4, 4), full[:6]])       # brick 0 of 4, rows -2..5
    last = torch.cat([full[10:], torch.zeros(2, 4, 4)])       # brick 3 of 4, rows 10..17
    x = y = torch.full((3,), 0.4)
    for slab, z_offset, cz in ((first, -2, [-0.1, 0.0, 0.01]), (last, 10, [0.99, 1.0, 1.2])):
        coords = F3(x, y, torch.tensor(cz))
        np.testing.assert_array_equal(
            sample_trilinear_zslab(slab, coords, z_offset, 16).numpy(),
            sample_trilinear(full, coords).numpy())


# ---- the plain bricked render ----------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_render_forward_bricked_matches_jax(name):
    jimg, timg, _ = renders(name)
    assert timg.shape == (H, W, 3) and timg.max() > 0
    # both sides relay 1 - prod T; JAX takes positions in closed form, the
    # port accumulates them, and a lit sample's normal feels the last bits of
    # its position. Measured at most 2.8e-6 (one pixel of lit_aliased, 1.7e-5
    # of its value), unlit 1.1e-8; the JAX package allows its bricked render
    # rtol=5e-4, atol=1e-5 against its own single-device one
    np.testing.assert_allclose(timg, jimg, atol=5e-6, rtol=5e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_render_forward_bricked_matches_single_device(name):
    _, timg, single = renders(name)
    # positions are the single-device march's own; what differs is the entry
    # opacity 1 - prod T against the sequential recurrence. Measured at most
    # 6.0e-8 (lit_aliased, scale 0.27); the JAX package allows itself
    # rtol=5e-4, atol=1e-5 (tests/test_bricks.py)
    np.testing.assert_allclose(timg, single, atol=5e-7, rtol=1e-5)


def test_bricked_scene_is_split_once_and_reused():
    _, tscene = make_scenes(vol_shape=VOL)
    opts = tscene.options(W, H)
    mesh = make_mesh(4, "cpu")
    split = bricks.split_bricks(tscene, mesh)
    assert split.n == 4 and split.mesh == mesh
    assert all(b.scene.emission.data.shape == (4 + 2 * brick_march.HALO, 16, 16)
               for b in split.bricks)
    # edge halos are zeros, inner halos the neighbours' rows
    em = tscene.emission.data
    assert not split.bricks[0].scene.emission.data[:2].any()
    assert not split.bricks[3].scene.emission.data[-2:].any()
    np.testing.assert_array_equal(split.bricks[1].scene.emission.data.numpy(), em[2:10].numpy())
    a = bricks.render_forward_bricked(split, opts)
    b = bricks.render_forward_bricked(tscene, opts, mesh=mesh)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="split over"):
        bricks.render_forward_bricked(split, opts, mesh=make_mesh(2, "cpu"))


def test_depth_one_volume_is_copied_whole():
    """A (1, H, W) reflection volume, the facade's default, goes to every
    brick as it is."""
    _, tscene = make_scenes(vol_shape=VOL, lighting=True)
    flat = tscene.reflection.replace(data=tscene.reflection.data[7:8].contiguous())
    tscene = tscene.replace(reflection=flat)
    opts = tscene.options(W, H)
    got = bricks.render_forward_bricked(tscene, opts, mesh=make_mesh(4, "cpu"))
    np.testing.assert_allclose(got.numpy(), render_forward(tscene, opts).numpy(),
                               atol=5e-7, rtol=1e-5)


@pytest.mark.parametrize("n", [4, 8])
def test_every_sample_has_one_owner(n):
    """With no absorption nothing stops a ray early, so the bricks' sample
    counts must add up to the single-device march's, ray by ray: a sample
    owned twice or by no brick would show as a whole sample. The camera
    sends rays along the brick faces, some rising and some falling in z."""
    _, tscene = make_scenes(vol_shape=VOL, rotate=(88.0, 0.0, 0.0), factors=(1.0, 0.4, 0.0))
    opts = tscene.options(32, 32)
    single = torch.zeros((32, 32), dtype=torch.int32)
    render_forward_fast(tscene, opts, steps=single)
    split = bricks.split_bricks(tscene, make_mesh(n, "cpu"))
    step_z = brick_march.BrickRays(split.bricks[0], opts, 0.0).step.z
    assert bool((step_z > 0).any()) and bool((step_z < 0).any())
    total = torch.zeros_like(single)
    touched = torch.zeros_like(single)
    for brick in split.bricks:
        steps = torch.zeros_like(single)
        w, _ = cuda_bricks.brick_transmittance(brick, opts, steps=steps)
        assert not w.any()  # no absorption: no opacity
        total += steps
        touched += (steps > 0).to(torch.int32)
    assert int(single.sum()) > 10000
    np.testing.assert_array_equal(total.numpy(), single.numpy())
    assert int(touched.max()) >= 2  # rays do cross brick faces


# ---- errors ------------------------------------------------------------------


def test_indivisible_depth_raises():
    _, tscene = make_scenes(vol_shape=(10, 12, 10))
    opts = tscene.options(W, H)
    for entry in (bricks.render_forward_bricked, bricks.render_forward_bricked_fast):
        with pytest.raises(ValueError, match="divisible"):
            entry(tscene, opts, mesh=make_mesh(4, "cpu"))
    with pytest.raises(ValueError, match="divisible"):
        bricks.split_params_bricked(tscene, make_mesh(4, "cpu"))


def test_brick_depth_below_two_raises():
    _, tscene = make_scenes(vol_shape=(8, 12, 10))
    with pytest.raises(ValueError, match="brick depth"):
        bricks.render_forward_bricked_fast(tscene, tscene.options(W, H), mesh=make_mesh(8, "cpu"))


def test_mesh_must_be_a_device_list():
    _, tscene = make_scenes(vol_shape=VOL)
    with pytest.raises(ValueError, match="list of devices"):
        bricks.render_forward_bricked(tscene, tscene.options(W, H), mesh=None)
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(0, "cpu")
    assert make_mesh(3, ["cpu"]) == [torch.device("cpu")] * 3


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)


@pytest.mark.parametrize("gradient_volumes", [False, True])
def test_fast_entry_points_refuse_lit_scenes(gradient_volumes):
    """What the fast entry points refuse of a lit scene: since the lit forms
    of phase 2 and of the gradient segment, and the lookup form of the
    segment, nothing. The render of either scene goes through, and so do
    the gradients of both, the lookup scene's with the three gradient
    volumes' grids (cut like emission's), within 1e-5 of scale of
    single-device ``voxel_grads_fast``."""
    _, tscene = make_scenes(vol_shape=VOL, lighting=True, gradient_volumes=gradient_volumes)
    opts = tscene.options(16, 16)
    mesh = make_mesh(4, "cpu")
    img = bricks.render_forward_bricked_fast(tscene, opts, mesh=mesh)
    np.testing.assert_allclose(img.numpy(), render_forward(tscene, opts).numpy(),
                               rtol=0, atol=1e-7)
    g = (np.random.RandomState(3).randn(16, 16, 3) * 1e-3).astype(np.float32)
    brick = bricks.split_bricks(tscene, mesh).bricks[1]
    w, entry = cuda_bricks.brick_transmittance(brick, opts)
    _, grads = bricks.voxel_grads_bricked_fast(tscene, opts, g, mesh=mesh)
    assert "light_colors" in grads and "reflection" in grads
    lookup_keys = {"gradient_x", "gradient_y", "gradient_z"}
    assert (lookup_keys <= set(grads)) == gradient_volumes
    _, want = voxel_grads_fast(tscene, opts, g)
    assert set(grads) == set(want)
    for key, value in want.items():
        got = bricks.assemble(grads[key]) if isinstance(grads[key], list) else grads[key]
        err = float((got - value).abs().max()) / max(float(value.abs().max()), 1e-30)
        assert err <= 1e-5, f"{key}: {err:.3e} of scale"
    padded = cuda_bricks.brick_gradients(brick, opts, 0.0, torch.from_numpy(g), img, w, w,
                                         entry)
    for key in lookup_keys & set(padded):
        assert padded[key].shape == brick.scene.emission.data.shape


# ---- the fast entry points' CPU path ---------------------------------------


@pytest.mark.parametrize("rotate,n", [((10.0, 5.0, 0.0), 4), ((180.0, 0.0, 0.0), 8)])
def test_render_forward_bricked_fast_matches_jax_kernel(rotate, n):
    """Against the JAX package's kernel per brick, Pallas in interpret mode
    as ``tests/test_bricks.py`` runs it (z-principal cameras, its envelope)."""
    jscene, tscene = make_scenes(vol_shape=VOL, rotate=rotate)
    jimg = np.asarray(jax_bricked_fast(jscene, jscene.options(32, 32),
                                       mesh=jax_make_mesh(n, axis_name="bricks")))
    assert last_fallback_reason() is None
    opts = tscene.options(32, 32)
    before = dict(cuda_march.LAUNCHES_BY_MODE)
    timg = bricks.render_forward_bricked_fast(tscene, opts, mesh=make_mesh(n, "cpu"))
    assert cuda_march.LAUNCHES_BY_MODE == before  # on the CPU no kernel launch is counted
    # the JAX package holds its kernel to atol=3e-5, rtol=3e-4; measured 1.8e-8
    np.testing.assert_allclose(timg.numpy(), jimg, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(timg.numpy(), render_forward_fast(tscene, opts).numpy(),
                               atol=5e-7, rtol=1e-5)


@pytest.mark.parametrize("name", ["unlit", "dz_negative", "low_threshold", "grazing_mixed"])
def test_fast_cpu_path_is_the_plain_bricked_render(name):
    scene_kw, n = CASES[name]
    _, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    fast = bricks.render_forward_bricked_fast(tscene, tscene.options(W, H),
                                              mesh=make_mesh(n, "cpu"))
    np.testing.assert_array_equal(fast.numpy(), renders(name)[1])


def test_exit_opacity_of_one_brick_feeds_the_next():
    """Along rays that rise in z the exit opacity of brick b is the entry
    opacity of brick b + 1, up to the rounding of 1 - prod T."""
    _, tscene = make_scenes(vol_shape=VOL, rotate=(0.0, 0.0, 0.0))
    opts = tscene.options(W, H)
    split = bricks.split_bricks(tscene, make_mesh(4, "cpu"))
    fwd = bricks._forward(split, opts, 0.0, fast=True)
    assert bool(fwd.ascending.all())
    for b in range(3):
        _, w_out = cuda_bricks.brick_segment(split.bricks[b], opts, 0.0, fwd.w_in[b],
                                             fwd.entry[b])
        np.testing.assert_allclose(w_out.numpy(), fwd.w_in[b + 1].numpy(), atol=3e-7, rtol=0)


# ---- the entry record ------------------------------------------------------

RESUME_CASES = [(name, n) for name in ("unlit", "dz_negative", "low_threshold", "grazing_mixed")
                for n in (4, 8)]


@functools.lru_cache(maxsize=None)
def split_forward(name, n):
    """(scene, options, bricked scene, plain bricked forward) of a case."""
    _, tscene = make_scenes(vol_shape=VOL, **CASES[name][0])
    opts = tscene.options(W, H)
    split = bricks.split_bricks(tscene, make_mesh(n, "cpu"))
    return tscene, opts, split, bricks._forward(split, opts, 0.0, fast=False)


def ray_kinds(brick, opts, w_in, entry, threshold):
    """Masks (H, W) of the rays of a brick that the record must handle."""
    hit = brick_march.BrickRays(brick, opts, 0.0).hit.reshape(entry.step.shape)
    return {"misses the box": ~hit, "never reaches the brick": hit & (entry.step < 0),
            "first sample at step 0": entry.step == 0,
            "enters above the threshold": (entry.step > 0) & (w_in > threshold)}


@pytest.mark.parametrize("name,n", RESUME_CASES)
def test_shaded_pass_resumed_from_the_record_is_the_walk_from_step_zero(name, n):
    """Phase 2 from phase 1's record takes the same samples at the same
    positions as phase 2 walked from step 0: image, exit opacity and sample
    counts equal to the bit, for every kind of ray."""
    tscene, opts, split, fwd = split_forward(name, n)
    threshold = float(tscene.settings.opacity_threshold)
    seen = dict.fromkeys(ray_kinds(split.bricks[0], opts, fwd.w_in[0], fwd.entry[0], threshold), 0)
    for brick, w_in, entry in zip(split.bricks, fwd.w_in, fwd.entry):
        walked_steps = torch.zeros((H, W), dtype=torch.int32)
        resumed_steps = torch.zeros((H, W), dtype=torch.int32)
        walked = brick_march.shaded_pass(brick, opts, 0.0, w_in, walked_steps)
        resumed = brick_march.shaded_pass(brick, opts, 0.0, w_in, resumed_steps, entry=entry)
        assert torch.equal(resumed[0], walked[0]) and torch.equal(resumed[1], walked[1])
        assert torch.equal(resumed_steps, walked_steps)
        for kind, mask in ray_kinds(brick, opts, w_in, entry, threshold).items():
            seen[kind] += int(mask.sum())
            if kind != "first sample at step 0":  # these rays take no sample
                assert not resumed_steps[mask].any() and not resumed[0][mask].any()
                assert torch.equal(resumed[1][mask], w_in[mask])
    assert all(seen[k] > 0 for k in seen if k != "enters above the threshold"), seen
    assert (seen["enters above the threshold"] > 0) == (threshold < 0.5), seen


@pytest.mark.parametrize("name,n", RESUME_CASES[::2])
def test_entry_record_is_the_first_step_the_brick_owns(name, n):
    """Every record points into its brick, and the records of one ray over
    all bricks are in the ray's own order of the bricks."""
    tscene, opts, split, fwd = split_forward(name, n)
    rays = brick_march.BrickRays(split.bricks[0], opts, 0.0)
    boxmin, boxscale = rays.consts.boxmin[2], rays.consts.boxscale[2]
    rising = (rays.step.z > 0).reshape(H, W)
    for b, entry in enumerate(fwd.entry):
        ok = entry.step >= 0
        assert entry.step.dtype == torch.int32 and entry.state.shape == (H, W, 4)
        owner = torch.clamp(torch.floor((entry.state[..., 3] - boxmin) * boxscale * float(n)),
                            0.0, n - 1.0)
        assert bool((owner[ok] == b).all())
        assert not entry.state[~ok].any()
        if b > 0:  # a rising ray reaches brick b after brick b - 1
            before = fwd.entry[b - 1].step
            both = ok & (before >= 0)
            assert bool(torch.where(rising, entry.step > before, entry.step < before)[both].all())


def test_resumed_passes_require_the_record():
    tscene, opts, split, fwd = split_forward("unlit", 4)
    brick, w_in = split.bricks[1], fwd.w_in[1]
    with pytest.raises(TypeError, match="brick_transmittance"):
        cuda_bricks.brick_segment(brick, opts, 0.0, w_in, None)
    g = torch.zeros((H, W, 3))
    with pytest.raises(TypeError, match="brick_transmittance"):
        cuda_bricks.brick_gradients(brick, opts, 0.0, g, fwd.image, w_in, torch.zeros((H, W)),
                                    None)


def other_camera_brick(n, index):
    """Brick ``index`` of the "unlit" scene seen from another camera."""
    _, tscene = make_scenes(vol_shape=VOL, rotate=(120.0, 40.0, 0.0))
    return bricks.split_bricks(tscene, make_mesh(n, "cpu")).bricks[index]


def other_record(kind, opts, split, fwd):
    """(brick, options, camera_x_offset, y_offset, n_rows, record) where a
    brick resumes from a record of brick 1 made for something else; the pass
    keeps the shapes of its planes."""
    brick, entry = split.bricks[1], fwd.entry[1]
    if kind == "another brick":
        return brick, opts, 0.0, 0, None, fwd.entry[2]
    if kind == "another camera_x_offset":
        return brick, opts, 0.1, 0, None, entry
    if kind == "another camera":
        return other_camera_brick(len(split.bricks), 1), opts, 0.0, 0, None, entry
    if kind == "other options":
        return brick, RenderOptions(W, H, opts.boxmin, opts.boxmax, opts.tstep,
                                    opts.gradient_step, opts.n_steps - 1), 0.0, 0, None, entry
    return brick, opts, 0.0, 0, H - 4, entry.rows(2, H - 4)  # another band of rows


@pytest.mark.parametrize("kind", ["another brick", "another camera_x_offset", "another camera",
                                  "other options", "another band"])
def test_resumed_passes_refuse_a_record_made_for_something_else(kind):
    """A record fits only the brick, options, camera, camera offset and rows
    of the phase 1 that made it: the wrappers and the plain passes raise for
    any other, where resuming from it would take wrong samples without a
    word."""
    _, opts, split, fwd = split_forward("unlit", 4)
    brick, other_opts, cam, y0, rows, entry = other_record(kind, opts, split, fwd)
    cut = slice(y0, y0 + (H if rows is None else rows))
    w_in, image, up = fwd.w_in[1][cut], fwd.image[cut], torch.zeros((H, W))[cut]
    g = torch.ones_like(image)
    band = dict(y_offset=y0, n_rows=rows)
    calls = [lambda: brick_march.shaded_pass(brick, other_opts, cam, w_in, entry=entry, **band),
             lambda: brick_march.replay_pass(brick, other_opts, cam, g, image, w_in, up,
                                             entry=entry, **band)]
    if rows is None:  # the wrappers march the whole image
        calls += [lambda: cuda_bricks.brick_segment(brick, other_opts, cam, w_in, entry),
                  lambda: cuda_bricks.brick_gradients(brick, other_opts, cam, g, image, w_in, up,
                                                      entry)]
    for call in calls:
        with pytest.raises(ValueError, match="entry record was made for"):
            call()


def test_record_of_a_band_keeps_the_camera():
    """``Entry.rows`` cuts the record to a band and keeps the rest of its key:
    the band's record is refused under another camera too, and taken under
    its own."""
    _, opts, split, fwd = split_forward("unlit", 4)
    brick, entry = split.bricks[1], fwd.entry[1]
    band = entry.rows(2, H - 4)
    assert band.made_for.camera == entry.made_for.camera == brick.scene.camera.key()
    assert band.made_for._replace(first_row=0, rows=H) == entry.made_for
    w_in = fwd.w_in[1][2:H - 2]
    rows = dict(y_offset=2, n_rows=H - 4)
    with pytest.raises(ValueError, match="entry record was made for another march: camera"):
        brick_march.shaded_pass(other_camera_brick(4, 1), opts, 0.0, w_in, entry=band, **rows)
    got = brick_march.shaded_pass(brick, opts, 0.0, w_in, entry=band, **rows)
    want = brick_march.shaded_pass(brick, opts, 0.0, w_in, **rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def brute_force_flushes(brick, opts, w_in, entry, grid=None):
    """The corner carry's atomic adds into one grid (emission's cells, or
    those of ``grid``), ray by ray in plain Python: the cells of each ray's
    samples from the walk (from ``entry``, or from step 0 without it), then
    8 minus the corners two consecutive cells share, and 8 for the last
    cell. The same sum counts the gather cache's loads: 8 for the first
    cell, then 8 minus the corners shared at each move."""
    rays = brick_march.BrickRays(brick, opts, 0.0)
    consts, sample_ab = rays.consts, brick_march.brick_samplers(brick).ab
    em = brick.scene.emission.data if grid is None else grid
    dims = (em.shape[2], em.shape[1], brick.slab_geometry(em)[1])
    samples = []

    def composite(pos, act, sw):
        s = core.to_sample_coords(pos, consts)
        samples.append((act.clone(), [torch.clamp(torch.floor(c * float(d) - 0.5), -1.0, float(d))
                                      for c, d in zip(s, dims)]))
        ab = sample_ab(s)
        return 1.0 - torch.exp(-(consts.factor_absorption * ab) * consts.tstep)

    rays.walk(w_in, composite, entry=entry)
    total, flushes = 0, 0
    for r in range(H * W):
        cells = [tuple(int(c[r]) for c in corner) for act, corner in samples if act[r]]
        total += len(cells)
        for a, b in zip(cells, cells[1:]):
            d = [abs(i - j) for i, j in zip(a, b)]
            flushes += 8 - (int(np.prod([2 - k for k in d])) if max(d) <= 1 else 0)
        flushes += 8 if cells else 0
    return total, flushes


# (samples, flushes) of brick 1 of each case: the step is under half a voxel,
# so a ray's samples share a cell or four corners most of the time
STATED_FLUSHES = {"unlit": (2173, 3340), "low_threshold": (395, 732),
                  "grazing_mixed": (3812, 3144)}


@pytest.mark.parametrize("name", list(STATED_FLUSHES))
def test_corner_flush_count(name):
    """``chip_smoke.corner_flushes`` counts the atomic adds of the gradient
    segment's corner carry from the plain walk: the stated number, equal to
    a count ray by ray, also walked from step 0, and far under the 8 a
    sample of a scatter without the carry."""
    n = CASES[name][1]
    _, opts, split, fwd = split_forward(name, n)
    brick, w_in, entry = split.bricks[1], fwd.w_in[1], fwd.entry[1]
    counted = chip_smoke.corner_flushes(brick, opts, w_in, entry)
    assert counted == brute_force_flushes(brick, opts, w_in, entry) == STATED_FLUSHES[name]
    assert counted == chip_smoke.corner_flushes(brick, opts, w_in, None)  # walked from step 0
    samples, flushes = counted
    assert 0 < flushes < 2 * samples


# scene arguments, bricks, and the samples and corner loads of phase 1's
# gather cache in brick 1; absorption of another shape is cut from the
# scene's (16, 16, 16) to (16, 8, 5) (the cache then runs on its cells)
LOAD_CASES = {
    "absorption_separate": (dict(), 8, (2173, 3340)),
    "absorption_aliased": (dict(alias_absorption=True), 4, (3942, 5128)),
    "absorption_other_shape": (dict(), 4, (3942, 4062)),
    "low_threshold": (dict(factors=(3.0, 0.4, 4.0), opacity_threshold=0.3), 4, (1443, 2692)),
    "grazing_mixed": (dict(rotate=(88.0, 0.0, 0.0)), 4, (3812, 3144)),
}


@pytest.mark.parametrize("name", list(LOAD_CASES))
def test_corner_load_count(name):
    """``chip_smoke.corner_loads`` counts the loads of phase 1's corner
    cache from the plain walk, on the cells of the volume phase 1 fetches:
    the stated number, equal to a count ray by ray, the same walked from
    step 0, taken on phase 1's samples, and far under the 8 a sample of a
    fetch without the cache."""
    scene_kw, n, stated = LOAD_CASES[name]
    _, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    if name == "absorption_other_shape":
        ab = tscene.absorption.data[:, ::2, 1::3].contiguous()
        tscene = tscene.replace(absorption=tscene.absorption.replace(data=ab))
    opts = tscene.options(W, H)
    brick = bricks.split_bricks(tscene, make_mesh(n, "cpu")).bricks[1]
    steps = torch.zeros((H, W), dtype=torch.int32)
    _, entry = brick_march.transmittance_pass(brick, opts, 0.0, steps)
    grid = brick.scene.absorption_volume.data
    counted = chip_smoke.corner_loads(brick, opts, None, entry)
    assert counted == brute_force_flushes(brick, opts, None, entry, grid) == stated
    assert counted == chip_smoke.corner_loads(brick, opts, None, None)  # walked from step 0
    samples, loads = counted
    assert samples == int(steps.sum())
    assert 0 < loads < 2 * samples


# ---- training ----------------------------------------------------------------


def test_split_params_bricked_and_params_from_arrays_agree():
    _, tscene = make_scenes(vol_shape=VOL)
    mesh = make_mesh(4, "cpu")
    params, static = bricks.split_params_bricked(tscene, mesh)
    whole, _ = train.split_params(tscene)
    carried = params_from_arrays({k: v.detach().numpy() for k, v in whole.items()}, mesh=mesh)
    assert set(params) == set(carried) == set(whole)
    for key, value in params.items():
        if key in ("emission", "absorption"):
            assert len(value) == len(carried[key]) == 4
            assert all(p.requires_grad and p.is_leaf and p.shape == (4, 16, 16) for p in value)
            np.testing.assert_array_equal(bricks.assemble(value).detach().numpy(),
                                          whole[key].detach().numpy())
            np.testing.assert_array_equal(bricks.assemble(carried[key]).detach().numpy(),
                                          whole[key].detach().numpy())
        else:
            np.testing.assert_array_equal(value.detach().numpy(), carried[key].detach().numpy())
    assert len(bricks.param_leaves(params)) == 4 + 4 + 4
    assert static.n == 4


@pytest.mark.parametrize("alias_absorption", [False, True])
def test_train_step_fast_bricked_follows_the_single_device_step(alias_absorption):
    """Three Adam steps on per-brick parameters against ``train_step_fast``
    on the whole grids: the same losses and the same parameters."""
    _, tscene = make_scenes(vol_shape=VOL, rotate=(125.0, 25.0, 0.0),
                            alias_absorption=alias_absorption)
    opts = tscene.options(W, H)
    target = render_forward(tscene, opts)
    mesh = make_mesh(4, "cpu")

    params, static = train.split_params(tscene)
    bparams, bstatic = bricks.split_params_bricked(tscene, mesh)
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
        for p in bparams["emission"]:
            p.mul_(1.3).add_(0.05)
    opt = torch.optim.Adam(list(params.values()), lr=2e-3)
    bopt = torch.optim.Adam(bricks.param_leaves(bparams), lr=2e-3)
    losses, blosses = [], []
    for _ in range(3):
        losses.append(float(train.train_step_fast(params, opt, static, opts, target)))
        blosses.append(float(bricks.train_step_fast_bricked(bparams, bopt, bstatic, opts, target,
                                                            mesh=mesh)))
    assert blosses[2] < blosses[1] < blosses[0]
    np.testing.assert_allclose(blosses, losses, rtol=1e-5)
    for key, value in params.items():
        got = bricks.assemble(bparams[key]) if isinstance(bparams[key], list) else bparams[key]
        # Adam divides by the gradient's running magnitude, so where a
        # gradient is rounding noise the two updates differ freely; the
        # updates themselves are 2e-3 a step
        np.testing.assert_allclose(got.detach().numpy(), value.detach().numpy(), atol=2e-4)
