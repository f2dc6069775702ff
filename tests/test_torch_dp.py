"""The port's rays-DP path (``parallel/sharding.py``, ``parallel/pallas_dp.py``,
``train.train_step_sharded``) and the rows x bricks mesh of
``parallel/bricks.py`` on the CPU, against the JAX package (its
``parallel.sharding`` on the 8 virtual CPU devices of ``conftest.py``) and
against the port's own single-device paths.

Scenes are 14^3-16^3 (``make_scenes``: numpy from a seed, carried across by
``scene_from_arrays``), images at most 32^2; every band lies on ``"cpu"``,
where the kernels' wrappers run their plain versions.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from volume_renderer_tpu import train as jax_train
from volume_renderer_tpu.ops.forward import render_forward as jax_render_forward
from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene
from volume_renderer_tpu.parallel.bricks import render_forward_bricked as jax_bricked
from volume_renderer_tpu.parallel.sharding import make_mesh as jax_make_mesh
from volume_renderer_tpu.parallel.sharding import render_forward_sharded as jax_sharded

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.convert import params_from_arrays
from volume_renderer_tpu_torch.ops import cuda_march
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast, zero_grids
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast, render_rows_fast
from volume_renderer_tpu_torch.ops.forward import render_rows
from volume_renderer_tpu_torch.ops.vjp import merge_scene, split_scene
from volume_renderer_tpu_torch.parallel import bricks, pallas_dp, sharding
from volume_renderer_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

torch.set_num_threads(1)

VOL = (16, 16, 16)
# 22 rows: neither 8 nor 5 bands divide them (ceil: 3 and 5 rows a band)
W, H = 24, 22
SCENES = {
    "unlit": dict(),
    "lit_otf": dict(lighting=True),
    "lit_lookup": dict(lighting=True, gradient_volumes=True),
}
# Both sides march the same formulas (tests/test_torch_march.py holds the
# single-device render to the same tolerance); a band's rays are the whole
# image's.
ATOL, RTOL = 1e-6, 1e-5


@functools.lru_cache(maxsize=None)
def scenes(name):
    return make_scenes(vol_shape=VOL, **SCENES[name])


@functools.lru_cache(maxsize=None)
def single_images(name):
    """(the port's render_forward_fast, the JAX package's render_forward)."""
    jscene, tscene = scenes(name)
    return (render_forward_fast(tscene, tscene.options(W, H)),
            np.asarray(jax_render_forward(jscene, jscene.options(W, H))))


# ---- the band arithmetic ---------------------------------------------------


@pytest.mark.parametrize("height,n,want", [
    (22, 8, [(0, 3), (3, 3), (6, 3), (9, 3), (12, 3), (15, 3), (18, 3), (21, 1)]),
    (22, 5, [(0, 5), (5, 5), (10, 5), (15, 5), (20, 2)]),
    (12, 5, [(0, 3), (3, 3), (6, 3), (9, 3), (12, 0)]),
    (512, 4, [(0, 128), (128, 128), (256, 128), (384, 128)]),
])
def test_bands_cover_the_image_once(height, n, want):
    assert sharding.bands(height, n) == want


def test_march_args_carry_the_band():
    """The kernels' arguments of a band: its rows, its first image row and
    the image's height, and the aspect ratio of the whole image."""
    _, tscene = scenes("unlit")
    opts = tscene.options(W, H)
    whole, _ = cuda_march.march_args(tscene, opts, 0.0, lookup=False)
    band, _ = cuda_march.march_args(tscene, opts, 0.0, lookup=False, y_offset=15, n_rows=5)
    assert (whole.row0, whole.height, whole.image_height) == (0, H, H)
    assert (band.row0, band.height, band.image_height, band.width) == (15, 5, H, W)
    assert band.ratio == whole.ratio == np.float32(np.float32(H) / np.float32(W))
    for y0, rows in ((-1, 3), (20, 3), (0, H + 1)):
        with pytest.raises(ValueError, match="not inside the image"):
            cuda_march.march_args(tscene, opts, 0.0, lookup=False, y_offset=y0, n_rows=rows)


def test_scene_to_copies_every_tensor_once_a_device():
    """``scenes_on`` copies the scene to each distinct device of the mesh
    once, every tensor of it (here to the meta device, which holds no data),
    and leaves it where it lies already."""
    _, tscene = scenes("lit_lookup")
    on = sharding.scenes_on(tscene, [torch.device("cpu"), torch.device("meta")] * 2)
    assert list(on) == [torch.device("cpu"), torch.device("meta")]
    assert on[torch.device("cpu")] is tscene
    moved = on[torch.device("meta")]
    tensors = [moved.emission.data, moved.absorption.data, moved.reflection.data,
               moved.gradient_x.data, moved.illumination, moved.light_positions,
               moved.light_colors, moved.camera.rotation, moved.settings.color,
               moved.settings.opacity_threshold]
    assert all(t.device.type == "meta" for t in tensors)
    assert moved.camera.key() == tscene.camera.key()


# ---- (a) the plain rays-DP render against the JAX package --------------------


@functools.lru_cache(maxsize=None)
def jax_sharded_image(name, n):
    jscene, _ = scenes(name)
    return np.asarray(jax_sharded(jscene, jscene.options(W, H), mesh=jax_make_mesh(n)))


@pytest.mark.parametrize("n", [8, 5])
@pytest.mark.parametrize("name", ["unlit", "lit_otf"])
def test_render_forward_sharded_matches_jax(name, n):
    _, tscene = scenes(name)
    got = sharding.render_forward_sharded(tscene, tscene.options(W, H), mesh=make_mesh(n, "cpu"))
    want = jax_sharded_image(name, n)
    assert got.shape == (H, W, 3) and np.count_nonzero(want) > W * H
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_render_forward_sharded_is_differentiable():
    """The bands' copies to ``mesh[0]`` stay in autograd's graph: the
    gradient of the sharded render is the single-device one's."""
    _, tscene = make_scenes(vol_shape=(8, 8, 8))
    opts = tscene.options(10, 9)
    grads = []
    for mesh in (None, make_mesh(4, "cpu")):
        diff, template = split_scene(tscene)
        emission = diff["emission"].detach().requires_grad_(True)
        scene = template.replace(emission=template.emission.replace(data=emission))
        img = (render_rows(scene, opts, 0.0, 0, opts.height, differentiable=True)
               if mesh is None else
               sharding.render_forward_sharded(scene, opts, mesh=mesh, differentiable=True))
        img.square().sum().backward()
        grads.append(emission.grad)
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[1], grads[0], atol=0, rtol=1e-5)


# ---- (b) the rays-DP kernel entry on the CPU --------------------------------


@pytest.mark.parametrize("n", [8, 5, 1])
@pytest.mark.parametrize("name", list(SCENES))
def test_render_forward_fast_sharded_is_the_single_render(name, n):
    """Each band's pixel is the whole image's, so the bands joined are
    ``render_forward_fast``'s image bit for bit (on the card too: chip_smoke.py,
    dp_vs_single); and that image is the JAX package's render."""
    _, tscene = scenes(name)
    got = pallas_dp.render_forward_fast_sharded(tscene, tscene.options(W, H),
                                                mesh=make_mesh(n, "cpu"))
    single, want = single_images(name)
    assert torch.equal(got, single)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_render_rows_fast_takes_a_band_and_a_pack():
    _, tscene = scenes("lit_lookup")
    opts = tscene.options(W, H)
    whole = render_forward_fast(tscene, opts)
    steps = torch.zeros((6, W), dtype=torch.int32)
    band = render_rows_fast(tscene, opts, 0.0, 9, 6, steps=steps,
                            packed=cuda_march.pack_lookup(tscene))
    assert torch.equal(band, whole[9:15]) and int(steps.max()) > 0


# ---- (c) train_step_sharded against the JAX single-device step ---------------

TRAIN_W = TRAIN_H = 32
TRAIN_SCENE = dict(vol_shape=(14, 14, 14), rotate=(125.0, 25.0, 0.0))
# as tests/test_torch_train.py: at lr 1e-2 an SGD update would vanish below
# the float32 spacing of the parameters; at 10 it is visible
SGD_LR = 10.0


def perturbed(params):
    out = dict(params)
    out["emission"] = out["emission"] * 1.3 + 0.05
    return out


@functools.lru_cache(maxsize=None)
def jax_run(optimizer_name, n_steps):
    """Losses and final parameters of ``n_steps`` JAX single-device steps
    (``train.train_step``: the JAX ``train_step_sharded`` fails its own tests
    on the CPU mesh)."""
    jscene, _ = make_scenes(**TRAIN_SCENE)
    opts = jscene.options(TRAIN_W, TRAIN_H)
    target = jax_render_forward(jscene, opts)
    params, static_scene = jax_train.split_params(jscene)
    params = perturbed(params)
    opt = {"sgd": optax.sgd(SGD_LR), "adam": optax.adam(1e-3)}[optimizer_name]
    state = opt.init(params)
    losses = []
    for _ in range(n_steps):
        params, state, loss = jax_train.train_step(params, state, static_scene, opts, target, opt)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}, np.asarray(target)


def torch_run(step_fn, optimizer_name, n_steps, target, lighting=False):
    jscene, tscene = make_scenes(lighting=lighting, **TRAIN_SCENE)
    start = perturbed({k: np.asarray(v) for k, v in jax_train.split_params(jscene)[0].items()})
    params = params_from_arrays(start, device="cpu")
    opt = {"sgd": lambda p: torch.optim.SGD(p, lr=SGD_LR),
           "adam": lambda p: torch.optim.Adam(p, lr=1e-3)}[optimizer_name](list(params.values()))
    opts = tscene.options(TRAIN_W, TRAIN_H)
    losses = [float(step_fn(params, opt, tscene, opts, torch.from_numpy(target.copy())))
              for _ in range(n_steps)]
    return losses, {k: v.detach().numpy() for k, v in params.items()}


def sharded_step(n):
    return functools.partial(train.train_step_sharded, mesh=make_mesh(n, "cpu"))


# Tolerances of tests/test_torch_train.py, which holds the single-device port
# step to the same JAX step: the bands only sum the same terms in another
# order, and march the fixed trip count (the same values).
@pytest.mark.parametrize("n", [4, 8])
def test_train_step_sharded_one_sgd_step_matches_jax(n):
    jlosses, jparams, target = jax_run("sgd", 1)
    losses, params = torch_run(sharded_step(n), "sgd", 1, target)
    assert abs(losses[0] - jlosses[0]) / jlosses[0] < 1e-5
    assert set(params) == set(jparams)
    for key, want in jparams.items():
        np.testing.assert_allclose(params[key], want, rtol=2e-6, atol=3e-7, err_msg=key)


def test_train_step_sharded_three_adam_steps_match_jax():
    jlosses, jparams, target = jax_run("adam", 3)
    losses, params = torch_run(sharded_step(4), "adam", 3, target)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[2] < losses[0]
    for key, want in jparams.items():
        np.testing.assert_allclose(params[key], want, rtol=1e-4, atol=2e-5, err_msg=key)


# ---- (d) the rays-DP kernel gradients and step against single-device ---------

# Share of each gradient's largest magnitude, the bound chip_smoke.py holds
# the card's grids to. The bands replay the same samples; only the order of
# the sums differs (band by band, then over the bands). Measured at most
# 1.2e-6 (factor_reflection, lit, 5 bands).
GRAD_TOL = 1e-5


# Against the JAX package: the tolerances of tests/test_torch_grads.py, which
# holds single-device ``voxel_grads_fast`` to ``jax.vjp`` of the JAX
# ``render_fused`` (the replay that the JAX ``voxel_grads_fast`` falls back to
# and that its kernel tests hold it against). Lit, the kernel's angle adjoint
# floors 1 - r^2 where the JAX replay's does not.
JAX_GRAD_TOL = {False: 5e-5, True: 1e-3}


def cotangent(seed=1):
    return torch.from_numpy((np.random.RandomState(seed).randn(H, W, 3) * 1e-3)
                            .astype(np.float32))


@functools.lru_cache(maxsize=None)
def jax_grads(name):
    """The JAX package's single-device gradients of ``scenes(name)`` for
    ``cotangent()``."""
    jscene, _ = scenes(name)
    diff, template = jax_split_scene(jscene)
    _, vjp_fn = jax.vjp(
        lambda d: jax_render_fused(jax_merge_scene(template, d), jscene.options(W, H)), diff)
    return {k: np.asarray(v) for k, v in vjp_fn(cotangent().numpy())[0].items()}


@pytest.mark.parametrize("name,n", [("unlit", 8), ("unlit", 5), ("lit_otf", 5)])
def test_voxel_grads_fast_sharded_matches_single_device(name, n):
    """Every key of single-device ``voxel_grads_fast``, lit too: the reflection
    grid, ``light_colors`` and a nonzero ``factor_reflection``, which the JAX
    package's lit rays-DP step zeroes (``parallel/pallas_dp.py:241``); and
    every key of the JAX package's single-device gradients. The unlit scene
    has a reflection volume of its own: its grid is one of the shared zeroed
    grids (``zero_grids``), zero after the sum."""
    _, tscene = scenes(name)
    opts = tscene.options(W, H)
    g = cotangent()
    img, want = voxel_grads_fast(tscene, opts, g)
    dp_img, got = pallas_dp.voxel_grads_fast_sharded(tscene, opts, g, mesh=make_mesh(n, "cpu"))
    assert torch.equal(dp_img, img)
    assert set(got) == set(want)
    assert set(zero_grids(tscene)) == {"emission", "absorption", "reflection"}
    for key, value in want.items():
        scale = float(value.abs().max())
        err = float((got[key] - value).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-30), f"{key}: {err:.3e} of scale {scale:.3e}"
    jgrads = jax_grads(name)
    assert set(got) == set(jgrads)
    for key, value in jgrads.items():
        scale = max(float(np.abs(value).max()), 1e-12)
        err = float(np.abs(got[key].numpy() - value).max()) / scale
        assert err <= JAX_GRAD_TOL[name != "unlit"], f"{key}: {err:.3e} of the JAX scale"
    if name == "lit_otf":
        assert {"reflection", "light_colors"} <= set(got)
        assert float(got["factor_reflection"].abs()) > 0
    else:
        assert not got["reflection"].any()


# The tolerances of tests/test_torch_train.py for its one SGD step and its
# three Adam steps (Adam may move a voxel whose gradient is rounding noise by
# a share of its rate in either direction).
STEP_TOLS = {"sgd": (1, dict(rtol=2e-6, atol=3e-7)), "adam": (3, dict(rtol=1e-4, atol=2e-5))}


@pytest.mark.parametrize("lighting,optimizer", [(False, "sgd"), (False, "adam"), (True, "sgd")])
def test_train_step_fast_sharded_follows_the_single_device_step(lighting, optimizer):
    """``train_step_fast_sharded`` on 4 bands against ``train.train_step_fast``
    from the same start and, unlit, against the JAX package's single-device
    ``train.train_step`` (as test (c) and tests/test_torch_train.py hold the
    port's steps). Lit, ``factor_reflection`` moves, as on one device (the
    JAX package's lit rays-DP step zeroes its gradient,
    ``parallel/pallas_dp.py:241``)."""
    _, _, target = jax_run("sgd", 1)
    n_steps, tol = STEP_TOLS[optimizer]
    step = functools.partial(pallas_dp.train_step_fast_sharded, mesh=make_mesh(4, "cpu"))
    l_dp, p_dp = torch_run(step, optimizer, n_steps, target, lighting)
    l_one, p_one = torch_run(train.train_step_fast, optimizer, n_steps, target, lighting)
    np.testing.assert_allclose(l_dp, l_one, rtol=1e-6)
    for key, want in p_one.items():
        np.testing.assert_allclose(p_dp[key], want, **tol, err_msg=key)
    if not lighting:
        jlosses, jparams, _ = jax_run(optimizer, n_steps)
        np.testing.assert_allclose(l_dp, jlosses, rtol=1e-5)
        assert set(p_dp) == set(jparams)
        for key, want in jparams.items():
            np.testing.assert_allclose(p_dp[key], want, **tol, err_msg=key)
    start = perturbed({k: np.asarray(v) for k, v in jax_train.split_params(
        make_scenes(lighting=lighting, **TRAIN_SCENE)[0])[0].items()})
    moved = float(np.abs(p_dp["factor_reflection"] - start["factor_reflection"]))
    assert (moved > 0) == lighting


# ---- (e) what the rays-DP steps refuse ---------------------------------------


def test_lit_lookup_scene_raises_from_the_fast_dp_path():
    """Lit lookup gradient volumes, which no backward kernel took before
    K6L: the DP path on 4 bands gives every key of single-device
    ``voxel_grads_fast`` (the three gradient volumes' grids among them,
    shared zeroed grids a device) within ``GRAD_TOL`` of scale, every key
    of the JAX package's single-device gradients within the lit tolerance,
    and ``train_step_fast_sharded`` the single-device step's loss and
    parameters."""
    _, tscene = scenes("lit_lookup")
    opts = tscene.options(W, H)
    g = cotangent()
    img, want = voxel_grads_fast(tscene, opts, g)
    dp_img, got = pallas_dp.voxel_grads_fast_sharded(tscene, opts, g, mesh=make_mesh(4, "cpu"))
    assert torch.equal(dp_img, img)
    assert set(got) == set(want) == set(jax_grads("lit_lookup"))
    assert {"gradient_x", "gradient_y", "gradient_z"} <= set(zero_grids(tscene))
    for key, value in want.items():
        scale = float(value.abs().max())
        err = float((got[key] - value).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-30), f"{key}: {err:.3e} of scale {scale:.3e}"
    for key, value in jax_grads("lit_lookup").items():
        err = float(np.abs(got[key].numpy() - value).max()) / max(float(np.abs(value).max()),
                                                                   1e-12)
        assert err <= JAX_GRAD_TOL[True], f"{key}: {err:.3e} of the JAX scale"
    target = render_forward_fast(tscene, opts)
    runs = []
    for step in (functools.partial(pallas_dp.train_step_fast_sharded, mesh=make_mesh(4, "cpu")),
                 train.train_step_fast):
        params, static = train.split_params(tscene)
        with torch.no_grad():
            params["emission"].mul_(1.2).add_(0.05)
        opt = torch.optim.SGD(list(params.values()), lr=1e-3)
        runs.append((float(step(params, opt, static, opts, target)), params))
    (l_dp, p_dp), (l_one, p_one) = runs
    np.testing.assert_allclose(l_dp, l_one, rtol=1e-6)
    for key, want_p in p_one.items():
        np.testing.assert_allclose(p_dp[key].detach().numpy(), want_p.detach().numpy(),
                                   rtol=2e-6, atol=3e-7, err_msg=key)


def test_rays_dp_refusals():
    _, tscene = scenes("unlit")
    opts = tscene.options(W, H)
    params, static = train.split_params(tscene)
    opt = torch.optim.SGD(list(params.values()), lr=1.0)
    with pytest.raises(ValueError, match="divisible by mesh size 5"):
        train.train_step_sharded(params, opt, static, opts, torch.zeros(H, W, 3),
                                 mesh=make_mesh(5, "cpu"))
    with pytest.raises(ValueError, match="list of devices"):
        pallas_dp.render_forward_fast_sharded(tscene, opts, mesh=make_mesh_2d(2, 2, "cpu"))


# ---- (f) the rows x bricks mesh ----------------------------------------------

BW, BH = 16, 12
BVOL = (16, 12, 10)


@functools.lru_cache(maxsize=None)
def bricked_2d():
    """(JAX 2 x 4 bricked render, port 2 x 4, port single-device) of a lit
    scene, as tests/test_bricks.py:test_bricked_2d_mesh renders it."""
    jscene, tscene = make_scenes(vol_shape=BVOL, lighting=True)
    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    jimg = jax_bricked(jscene, jscene.options(BW, BH), mesh=Mesh(devices, ("rays", "bricks")),
                       ray_axis="rays")
    opts = tscene.options(BW, BH)
    timg = bricks.render_forward_bricked(tscene, opts, mesh=make_mesh_2d(2, 4, "cpu"))
    return np.asarray(jimg), timg.numpy(), render_forward_fast(tscene, opts).numpy()


def test_render_forward_bricked_2d_matches_jax():
    jimg, timg, single = bricked_2d()
    assert timg.shape == (BH, BW, 3) and timg.max() > 0
    # the tolerances of tests/test_torch_bricks.py for the 1-D bricked render
    np.testing.assert_allclose(timg, jimg, atol=5e-6, rtol=5e-5)
    np.testing.assert_allclose(timg, single, atol=5e-7, rtol=1e-5)


def test_render_fused_bricked_2d_grads_match_the_1d_mesh():
    """The rows x bricks gradients are the 1-D bricked path's, summed over
    the two bands: the same samples, the sums in another order (the
    tolerance of tests/test_torch_bricks_grads.py against single-device)."""
    _, tscene = make_scenes(vol_shape=BVOL, lighting=True)
    opts = tscene.options(BW, BH)
    g = torch.from_numpy((np.random.RandomState(3).randn(BH, BW, 3) * 1e-3).astype(np.float32))
    grads = []
    for mesh in (make_mesh(4, "cpu"), make_mesh_2d(2, 4, "cpu")):
        diff, template = split_scene(tscene)
        leaves = {k: v.detach().requires_grad_(True) for k, v in diff.items()}
        img = bricks.render_fused_bricked(merge_scene(template, leaves), opts, mesh=mesh)
        torch.sum(img * g).backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    assert set(grads[1]) == set(grads[0]) and "light_colors" in grads[0]
    for key, want in grads[0].items():
        scale = float(want.abs().max())
        assert scale > 0, key
        assert float((grads[1][key] - want).abs().max()) <= 1e-4 * scale, key


def test_bricked_2d_mesh_refusals():
    _, tscene = make_scenes(vol_shape=BVOL)
    opts = tscene.options(BW, BH)
    with pytest.raises(ValueError, match="divisible by the ray axis size 5"):
        bricks.render_forward_bricked(tscene, opts, mesh=make_mesh_2d(5, 4, "cpu"))
    with pytest.raises(ValueError, match="no ray axis"):
        bricks.render_forward_bricked_fast(tscene, opts, mesh=make_mesh_2d(2, 4, "cpu"))
    assert make_mesh_2d(2, 3, ["cpu"]) == [[torch.device("cpu")] * 3] * 2
