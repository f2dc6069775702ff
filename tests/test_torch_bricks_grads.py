"""Gradients through the port's z-brick path on the CPU: ``render_fused_bricked``
against the port's single-device ``render_fused`` and against ``jax.vjp`` of
the JAX package's ``render_fused_bricked`` (on the 8 virtual CPU devices of
``conftest.py``), every key; and ``voxel_grads_bricked_fast`` (on the CPU the
brick kernels' plain passes) against the port's ``voxel_grads_fast`` and the
JAX package's ``voxel_grads_bricked_fast`` with Pallas in interpret mode, as
``tests/test_bricks.py`` runs it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.pallas_march import last_fallback_reason
from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene
from volume_renderer_tpu.parallel.bricks import render_fused_bricked as jax_fused_bricked
from volume_renderer_tpu.parallel.bricks import voxel_grads_bricked_fast as jax_grads_fast
from volume_renderer_tpu.parallel.sharding import make_mesh as jax_make_mesh

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops import brick_march
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.vjp import merge_scene, render_fused, split_scene
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOL = (16, 16, 16)
W, H = 24, 20

# name: (scene arguments, number of bricks)
CASES = {
    "unlit": (dict(), 4),
    # Under make_scenes' default camera one sample of this volume sits on the
    # guard of the angle adjoint (|r| >= 1 - 1e-6), where the two packages'
    # single-device replays already part by 0.19 of the emission gradient's
    # scale; the bricks add nothing to that, so the lit case looks elsewhere.
    "lit_otf": (dict(lighting=True, rotate=(125.0, 25.0, 0.0)), 4),
    "lit_lookup": (dict(lighting=True, gradient_volumes=True), 4),
    "unlit_aliased": (dict(alias_absorption=True, alias_reflection=True), 8),
    "dz_negative": (dict(rotate=(180.0, 20.0, 0.0)), 8),
    "low_threshold": (dict(factors=(3.0, 0.4, 4.0), opacity_threshold=0.3), 8),
    "grazing_mixed": (dict(rotate=(88.0, 0.0, 0.0)), 4),
}
# the cases that also go through the JAX package (35 to 45 s of compilation each)
JAX_CASES = ("unlit", "lit_otf")

# Share of each gradient's largest magnitude. Bricked and single-device replay
# compute the same terms; they differ in the entry opacity (1 - prod T against
# the sequential recurrence) and in the order of the sums (per brick, then over
# bricks). Measured at most 1.3e-5 (factor_absorption, grazing_mixed: a scalar
# whose per-ray terms cancel under a cotangent of mixed sign); the grids 2.9e-7.
TOL_SINGLE = 1e-4
# Against JAX, the port's plain replay also sums each parameter per ray first
# (tests/test_torch_vjp.py allows 5e-4 for that on one device). Measured at
# most 2.5e-5 (reflection, lit_otf).
TOL_JAX = 3e-4


def cotangent(seed=1):
    return (np.random.RandomState(seed).randn(H, W, 3) * 1e-3).astype(np.float32)


def all_keys(scene_kw):
    keys = ["emission", "factor_emission", "factor_absorption", "factor_reflection", "color"]
    if not scene_kw.get("alias_absorption"):
        keys.append("absorption")
    if not scene_kw.get("alias_reflection"):
        keys.append("reflection")
    if scene_kw.get("lighting"):
        keys.append("light_colors")
    if scene_kw.get("gradient_volumes"):
        keys += ["gradient_x", "gradient_y", "gradient_z"]
    return sorted(keys)


def torch_grads(scene, render):
    diff, template = split_scene(scene)
    diff = {k: v.detach().clone().requires_grad_(True) for k, v in diff.items()}
    img = render(merge_scene(template, diff))
    img.backward(torch.from_numpy(cotangent()))
    return img.detach().numpy(), {k: v.grad.numpy() for k, v in diff.items()}


@functools.lru_cache(maxsize=None)
def port_results(name):
    """(single-device image and grads, bricked image and grads) of the port."""
    scene_kw, n = CASES[name]
    _, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    opts = tscene.options(W, H)
    mesh = make_mesh(n, "cpu")
    return (torch_grads(tscene, lambda s: render_fused(s, opts)),
            torch_grads(tscene, lambda s: bricks.render_fused_bricked(s, opts, mesh=mesh)))


@functools.lru_cache(maxsize=None)
def jax_results(name):
    scene_kw, n = CASES[name]
    jscene, _ = make_scenes(vol_shape=VOL, **scene_kw)
    opts = jscene.options(W, H)
    diff, template = jax_split_scene(jscene)
    mesh = jax_make_mesh(n, axis_name="bricks")
    img, vjp_fn = jax.vjp(
        lambda d: jax_fused_bricked(jax_merge_scene(template, d), opts, mesh=mesh), diff)
    grads = vjp_fn(jnp.asarray(cotangent()))[0]
    return np.asarray(img), {k: np.asarray(v) for k, v in grads.items()}


def rel_err(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


CASE_KEYS = [(name, key) for name, case in CASES.items() for key in all_keys(case[0])]
JAX_CASE_KEYS = [(name, key) for name in JAX_CASES for key in all_keys(CASES[name][0])]


@pytest.mark.parametrize("name", list(CASES))
def test_render_fused_bricked_image_and_keys(name):
    (simg, sgrads), (bimg, bgrads) = port_results(name)
    np.testing.assert_allclose(bimg, simg, atol=5e-7, rtol=1e-5)
    assert set(bgrads) == set(sgrads) == set(all_keys(CASES[name][0]))


@pytest.mark.parametrize("name,key", CASE_KEYS)
def test_render_fused_bricked_grads_match_single_device(name, key):
    (_, sgrads), (_, bgrads) = port_results(name)
    err = rel_err(bgrads[key], sgrads[key])
    assert err <= TOL_SINGLE, f"{name} {key}: {err:.3e} of the gradient's scale"


@pytest.mark.parametrize("name,key", JAX_CASE_KEYS)
def test_render_fused_bricked_grads_match_jax(name, key):
    _, (_, bgrads) = port_results(name)
    jimg, jgrads = jax_results(name)
    assert set(jgrads) == set(bgrads)
    err = rel_err(bgrads[key], jgrads[key])
    assert err <= TOL_JAX, f"{name} {key}: {err:.3e} of the gradient's scale"


def test_lit_gradients_are_not_trivial():
    """The lit cases do reach the shading chain: the reflection grid and the
    light colors get gradients."""
    (_, sgrads), (_, bgrads) = port_results("lit_otf")
    for key in ("reflection", "light_colors", "factor_reflection"):
        assert np.abs(bgrads[key]).max() > 0 and np.abs(sgrads[key]).max() > 0


def test_halo_rows_return_to_their_owners():
    """``_return_halo`` is the adjoint of ``_with_halo``:
    <with_halo(x), y> = <x, return_halo(y)>, and the outer halos of the
    edge bricks reach no one."""
    rng = np.random.default_rng(5)
    parts = [torch.from_numpy(rng.random((4, 3, 5)).astype(np.float32)) for _ in range(4)]
    padded = [torch.from_numpy(rng.random((8, 3, 5)).astype(np.float32)) for _ in range(4)]
    lhs = sum(float((a.double() * b.double()).sum())
              for a, b in zip(bricks._with_halo(parts), padded))
    rhs = sum(float((a.double() * b.double()).sum())
              for a, b in zip(parts, bricks._return_halo(padded)))
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)  # the fold adds in float32
    folded = bricks._return_halo(padded)
    np.testing.assert_allclose(
        folded[1][:2].numpy(), (padded[1][2:4] + padded[0][-2:]).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        folded[0][:2].numpy(), padded[0][2:4].numpy(), rtol=0)  # nothing folds into the edge


# ---- the entry record ------------------------------------------------------


@pytest.mark.parametrize("name,n", [(name, n) for name in ("unlit", "dz_negative",
                                                           "low_threshold", "grazing_mixed")
                                    for n in (4, 8)])
def test_replay_pass_resumed_from_the_record_is_the_walk_from_step_zero(name, n):
    """The gradient segment from phase 1's record replays the same samples
    at the same positions in the same order as the segment walked from step
    0: every key equal to the bit, on every brick."""
    _, tscene = make_scenes(vol_shape=VOL, **CASES[name][0])
    opts = tscene.options(W, H)
    split = bricks.split_bricks(tscene, make_mesh(n, "cpu"))
    fwd = bricks._forward(split, opts, 0.0, fast=False)
    g = torch.from_numpy(cotangent())
    up_dots = bricks._upstream([brick_march.own_dot(g, own) for own in fwd.own],
                               fwd.ascending, torch.cumsum, 0.0)
    for brick, w_in, up, entry in zip(split.bricks, fwd.w_in, up_dots, fwd.entry):
        args = (brick, opts, 0.0, g, fwd.image, w_in, up)
        walked = brick_march.replay_pass(*args, angle_floor=True)
        resumed = brick_march.replay_pass(*args, angle_floor=True, entry=entry)
        assert set(resumed) == set(walked)
        for key, value in walked.items():
            assert torch.equal(resumed[key], value), (brick.index, key)


# ---- the fast entry point's CPU path -----------------------------------------


@functools.lru_cache(maxsize=None)
def fast_results(name):
    scene_kw, n = CASES[name]
    _, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    opts = tscene.options(W, H)
    g = cotangent()
    simg, sgrads = voxel_grads_fast(tscene, opts, g)
    bimg, bgrads = bricks.voxel_grads_bricked_fast(tscene, opts, g, mesh=make_mesh(n, "cpu"))
    return (simg.numpy(), {k: v.numpy() for k, v in sgrads.items()}, bimg.numpy(), bgrads, n)


@pytest.mark.parametrize("name", ["unlit", "unlit_aliased", "dz_negative", "low_threshold",
                                  "grazing_mixed"])
def test_voxel_grads_bricked_fast_matches_voxel_grads_fast(name):
    simg, sgrads, bimg, bgrads, n = fast_results(name)
    np.testing.assert_allclose(bimg, simg, atol=5e-7, rtol=1e-5)
    assert set(bgrads) == set(sgrads)
    for key, want in sgrads.items():
        got = bgrads[key]
        if isinstance(got, list):  # a grid: one part per brick
            assert len(got) == n and all(p.shape == (VOL[0] // n,) + VOL[1:] for p in got)
            got = bricks.assemble(got)
        err = rel_err(got.numpy(), want)
        assert err <= TOL_SINGLE, f"{name} {key}: {err:.3e} of the gradient's scale"


@pytest.mark.parametrize("rotate,alias,n", [((10.0, 5.0, 0.0), False, 4),
                                            ((180.0, 0.0, 0.0), True, 8)])
def test_voxel_grads_bricked_fast_matches_jax_kernel(rotate, alias, n):
    """Against the JAX package's three kernel sweeps per brick, Pallas in
    interpret mode (z-principal cameras, its envelope)."""
    jscene, tscene = make_scenes(vol_shape=VOL, rotate=rotate, alias_absorption=alias)
    g = (np.random.RandomState(1).randn(32, 32, 3) * 1e-3).astype(np.float32)
    jimg, jgrads = jax_grads_fast(jscene, jscene.options(32, 32), g,
                                  mesh=jax_make_mesh(n, axis_name="bricks"))
    assert last_fallback_reason() is None
    timg, tgrads = bricks.voxel_grads_bricked_fast(tscene, tscene.options(32, 32), g,
                                                   mesh=make_mesh(n, "cpu"))
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-6, rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    for key, want in jgrads.items():
        got = tgrads[key]
        got = bricks.assemble(got) if isinstance(got, list) else got
        # the JAX package holds this kernel path to rtol=5e-3 against its
        # replay (tests/test_bricks.py); measured at most 1.9e-5 (absorption)
        err = rel_err(got.numpy(), np.asarray(want))
        assert err <= TOL_JAX, f"{key}: {err:.3e} of the gradient's scale"
