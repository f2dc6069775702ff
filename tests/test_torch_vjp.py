"""The port's ``render_fused`` (forward march + replay backward) against
``jax.vjp`` of the JAX package's ``render_fused``, and the replay against
``torch.autograd`` through the port's own ``differentiable=True`` march.

Each case's JAX and torch results are computed once and shared by the
assertions on its image and on each gradient key.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops.forward import render_forward, render_rows
from volume_renderer_tpu_torch.ops.vjp import (
    angle_backward,
    merge_scene,
    render_fused,
    replay_backward,
    split_scene,
)
from volume_renderer_tpu_torch.ops import raymarch_core as core
from volume_renderer_tpu_torch.ops.float3 import F3

torch.set_num_threads(1)

W, H = 40, 30
VOL = (14, 16, 18)

# scene arguments, then the render_fused arguments (y_offset, n_rows, early_exit)
CASES = {
    "unlit_aliased": (dict(alias_absorption=True), {}),
    "unlit_separate": (dict(), {}),
    "lit_otf_1_light": (dict(lighting=True), {}),
    "lit_otf_2_lights": (dict(lighting=True, n_lights=2, rotate=(200.0, 40.0, -30.0)), {}),
    "lit_otf_all_aliased": (dict(lighting=True, alias_reflection=True, alias_absorption=True), {}),
    "lit_lookup": (dict(lighting=True, gradient_volumes=True, factors=(1.2, 0.5, 0.7)), {}),
    "fixed_trip_count": (dict(alias_absorption=True), dict(early_exit=False)),
    "band": (dict(), dict(y_offset=9, n_rows=12)),
    "threshold_exit": (dict(factors=(1.0, 0.4, 40.0), opacity_threshold=0.5), {}),
}


def keys_of(scene_kw) -> tuple:
    keys = ["emission", "factor_emission", "factor_absorption", "factor_reflection", "color"]
    if not scene_kw.get("alias_absorption"):
        keys.append("absorption")
    if not scene_kw.get("alias_reflection"):
        keys.append("reflection")
    if scene_kw.get("lighting"):
        keys.append("light_colors")
    if scene_kw.get("gradient_volumes"):
        keys += ["gradient_x", "gradient_y", "gradient_z"]
    return tuple(sorted(keys))


CASE_KEYS = [(name, key) for name, (scene_kw, _) in CASES.items() for key in keys_of(scene_kw)]

# Same formulas on both sides; the sums over rays and steps are taken in
# another order, and the adjoint is written out by hand here and traced by
# jax.vjp there. Measured, as a share of each gradient's largest magnitude:
# at most 9.1e-5 (emission, lit with everything aliased), typically 1e-5.
GRAD_TOL = 5e-4
# against torch.autograd of the port's own march: at most 9.0e-7 measured
AUTOGRAD_TOL = 2e-5
# the image, as in test_torch_march.py (measured 1.3e-6, all aliased)
IMG_ATOL, IMG_RTOL = 5e-6, 1e-5


def cotangent(rows):
    return (np.random.RandomState(1).randn(rows, W, 3) * 1e-3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def results(name):
    """(jax image, jax grads, torch image, torch grads, autograd grads)."""
    scene_kw, fused_kw = CASES[name]
    jscene, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    rows = fused_kw.get("n_rows", H)
    g = cotangent(rows)

    jopts = jscene.options(W, H)
    diff, template = jax_split_scene(jscene)
    jimg, vjp_fn = jax.vjp(
        lambda d: jax_render_fused(jax_merge_scene(template, d), jopts, 0.125, **fused_kw), diff)
    jgrads = {k: np.asarray(v) for k, v in vjp_fn(jnp.asarray(g))[0].items()}

    topts = tscene.options(W, H)
    tdiff, ttemplate = split_scene(tscene)

    def leaves():
        return {k: v.clone().requires_grad_(True) for k, v in tdiff.items()}

    fused = leaves()
    timg = render_fused(merge_scene(ttemplate, fused), topts, 0.125, **fused_kw)
    timg.backward(torch.from_numpy(g))
    tgrads = {k: v.grad.numpy() for k, v in fused.items()}

    auto = leaves()
    aimg = render_rows(merge_scene(ttemplate, auto), topts, 0.125, fused_kw.get("y_offset", 0),
                       rows, differentiable=True)
    aimg.backward(torch.from_numpy(g))
    agrads = {k: None if v.grad is None else v.grad.numpy() for k, v in auto.items()}
    return np.asarray(jimg), jgrads, timg.detach().numpy(), tgrads, agrads


def assert_close_by_scale(got, want, tol, what):
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of the gradient's scale {scale:.3e} (tolerance {tol})"


@pytest.mark.parametrize("name", list(CASES))
def test_render_fused_primal_matches_jax(name):
    jimg, jgrads, timg, tgrads, _ = results(name)
    assert timg.shape == jimg.shape and np.count_nonzero(jimg) > W
    np.testing.assert_allclose(timg, jimg, atol=IMG_ATOL, rtol=IMG_RTOL)
    assert set(tgrads) == set(jgrads) == set(keys_of(CASES[name][0]))


@pytest.mark.parametrize("name,key", CASE_KEYS)
def test_render_fused_gradient_matches_jax(name, key):
    _, jgrads, _, tgrads, _ = results(name)
    assert_close_by_scale(tgrads[key], jgrads[key], GRAD_TOL, f"{name} {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_replay_matches_autograd_of_differentiable_march(name):
    _, _, _, tgrads, agrads = results(name)
    lit = CASES[name][0].get("lighting", False)
    for key, want in agrads.items():
        if want is None:  # autograd never reaches the unlit reflection leaves
            assert not lit and key in ("reflection", "factor_reflection")
            assert not tgrads[key].any()
            continue
        assert_close_by_scale(tgrads[key], want, AUTOGRAD_TOL, f"{name} {key}")


def test_differentiable_march_has_the_same_values():
    _, tscene = make_scenes(vol_shape=VOL, lighting=True)
    opts = tscene.options(W, H)
    np.testing.assert_array_equal(render_forward(tscene, opts, differentiable=True).numpy(),
                                  render_forward(tscene, opts).numpy())


def test_band_gradients_add_up_to_the_image():
    """Two bands' replays with the matching rows of g sum to the whole
    image's: the replay of a row depends on that row alone."""
    _, tscene = make_scenes(vol_shape=VOL, lighting=True)
    opts = tscene.options(W, H)
    g = torch.from_numpy(cotangent(H))
    img = render_forward(tscene, opts)
    whole = replay_backward(tscene, opts, g, img)
    top = replay_backward(tscene, opts, g[:11], img[:11], y_offset=0, n_rows=11)
    rest = replay_backward(tscene, opts, g[11:], img[11:], y_offset=11, n_rows=H - 11)
    for key, want in whole.items():
        assert_close_by_scale((top[key] + rest[key]).numpy(), want.numpy(), 1e-5, key)


def test_float64_accumulation_sums_the_same_float32_terms():
    _, tscene = make_scenes(vol_shape=VOL, lighting=True)
    opts = tscene.options(W, H)
    g = torch.from_numpy(cotangent(H))
    img = render_forward(tscene, opts)
    f32 = replay_backward(tscene, opts, g, img, angle_floor=True)
    f64 = replay_backward(tscene, opts, g, img, angle_floor=True, accum_dtype=torch.float64)
    assert set(f64) == set(f32)
    for key, want in f64.items():
        assert want.dtype == torch.float64 and f32[key].dtype == torch.float32
        # only the order and width of the sums differ: measured at most 7.5e-7
        assert_close_by_scale(f32[key].double().numpy(), want.numpy(), 5e-6, key)


def test_replay_rejects_wrong_shapes():
    _, tscene = make_scenes(vol_shape=VOL)
    opts = tscene.options(W, H)
    with pytest.raises(ValueError, match="g and image"):
        replay_backward(tscene, opts, torch.zeros(H, W, 3), torch.zeros(H - 1, W, 3))


@pytest.mark.parametrize("lighting,gradient_volumes", [(False, False), (True, False),
                                                       (True, True)])
def test_split_merge_scene_round_trip(lighting, gradient_volumes):
    kw = dict(lighting=lighting, gradient_volumes=gradient_volumes)
    jscene, tscene = make_scenes(vol_shape=VOL, **kw)
    diff, template = split_scene(tscene)
    assert set(diff) == set(jax_split_scene(jscene)[0]) == set(keys_of(kw))
    doubled = merge_scene(template, {k: v * 2.0 for k, v in diff.items()})
    for key, value in split_scene(doubled)[0].items():
        np.testing.assert_array_equal(value.numpy(), diff[key].numpy() * 2.0)
    assert doubled.camera is tscene.camera
    assert doubled.settings.opacity_threshold is tscene.settings.opacity_threshold
    assert doubled.emission.element_size_um == tscene.emission.element_size_um


def test_angle_backward_follows_autograd_and_floors_at_the_pole():
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    b[:, :8] = a[:, :8] * 2.0   # parallel pairs: ratio 1 within rounding
    b[:, 8:12] = 0.0            # zero-length: the guarded branch
    d_ang = torch.from_numpy(rng.randn(64).astype(np.float32))
    av, bv = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    core.angle(F3(*av), F3(*bv)).backward(d_ang)
    d_a, d_b = angle_backward(F3(*a), F3(*b), d_ang, floor=False)
    np.testing.assert_allclose(torch.stack(d_a).numpy(), av.grad.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(torch.stack(d_b).numpy(), bv.grad.numpy(), rtol=1e-4, atol=1e-6)
    assert not av.grad[:, :12].any()  # autograd: zero at the pole and at zero length
    f_a, _ = angle_backward(F3(*a), F3(*b), d_ang, floor=True)
    f_a = torch.stack(f_a)
    assert torch.isfinite(f_a).all() and not f_a[:, 8:12].any()
    # away from the poles the two conventions are one
    np.testing.assert_allclose(f_a[:, 12:].numpy(), torch.stack(d_a)[:, 12:].numpy(),
                               rtol=1e-6, atol=0)
