"""Camera gradients of the port's ``render_fused(camera_grads=True)``: the
rotation, the focal length, the distance to the object and the stereo x
offset, through the replay backward and one pull-back of the ray geometry.

Held against ``jax.vjp`` of the JAX package's ``render_fused(camera_grads=
True)`` on four scenes, every key; against ``torch.autograd`` of the port's
own fixed-trip march (``render_rows(differentiable=True)``), as the JAX
package's ``tests/test_camera_grad.py`` holds its fused path against its
scan; and by fitting a perturbed pose back.
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

from test_torch_helpers import arrays_of, make_scenes
from test_torch_vjp import assert_close_by_scale, kink_rays
from volume_renderer_tpu_torch.convert import scene_from_arrays
from volume_renderer_tpu_torch.ops.forward import render_forward, render_rows
from volume_renderer_tpu_torch.ops.vjp import (
    POSE_KEYS,
    merge_scene,
    render_fused,
    replay_backward,
    split_scene,
)

torch.set_num_threads(1)

W, H = 32, 24
VOL = (14, 16, 18)
X_OFFSET = 0.125

SCENES = {
    "unlit_separate": dict(),
    "unlit_aliased": dict(alias_absorption=True),
    "lit_otf": dict(lighting=True),
    "lit_lookup": dict(lighting=True, gradient_volumes=True),
}
# Rays with a sample within 2e-5 of a texel of a kink of the lit adjoint
# (tests/test_torch_vjp.py:kink_rays): there the last bits of the normal
# decide which side of the LUT's derivative jump a package takes. The lit
# OTF scene has none; the lookup scene two, whose cotangent is set to zero.
KINK_EPS = 2e-5
KINK_RAYS = {"lit_otf": 0, "lit_lookup": 2}

# Camera keys against the JAX package, as a share of each key's largest
# magnitude. Measured: unlit at most 5.5e-6 (camera_x_offset); lit 2.3e-4
# (OTF) and 2.5e-4 (lookup), both camera_x_offset, whose gradient is a sum
# of the view vector's cotangents through the angle adjoint of every sample
# (3.0e-4 on the lookup scene with its two kink rays kept).
CAMERA_TOL = 1e-3
# every other key as tests/test_torch_vjp.py holds it (measured at most 5.6e-5)
GRAD_TOL = 5e-4


def cotangent(seed=1):
    return (np.random.RandomState(seed).randn(H, W, 3) * 1e-3).astype(np.float32)


@functools.lru_cache(maxsize=None)
def results(name):
    """(JAX grads, port grads, port grads without camera_grads) of one scene,
    every key, for one cotangent."""
    scene_kw = SCENES[name]
    jscene, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    g = cotangent()
    if scene_kw.get("lighting"):
        near = kink_rays(tscene, tscene.options(W, H), KINK_EPS).numpy()
        assert int(near.sum()) == KINK_RAYS[name]
        g[near] = 0.0

    jopts = jscene.options(W, H)
    diff, template = jax_split_scene(jscene, with_camera=True)
    diff["camera_x_offset"] = jnp.float32(X_OFFSET)

    def jax_render(d):
        d = dict(d)
        x_offset = d.pop("camera_x_offset")
        return jax_render_fused(jax_merge_scene(template, d), jopts, x_offset,
                                camera_grads=True)

    _, vjp_fn = jax.vjp(jax_render, diff)
    jgrads = {k: np.asarray(v) for k, v in vjp_fn(jnp.asarray(g))[0].items()}

    topts = tscene.options(W, H)

    def port(camera_grads):
        tdiff, ttemplate = split_scene(tscene, with_camera=camera_grads)
        leaves = {k: v.clone().requires_grad_(True) for k, v in tdiff.items()}
        x_offset = torch.tensor(X_OFFSET, requires_grad=True) if camera_grads else X_OFFSET
        img = render_fused(merge_scene(ttemplate, leaves), topts, x_offset,
                           camera_grads=camera_grads)
        img.backward(torch.from_numpy(g))
        out = {k: v.grad for k, v in leaves.items()}
        if camera_grads:
            out["camera_x_offset"] = x_offset.grad
        return out

    return jgrads, port(True), port(False)


CASE_KEYS = [(name, key) for name in SCENES for key in sorted(
    set(jax_split_scene(make_scenes(vol_shape=(4, 4, 4), **SCENES[name])[0],
                        with_camera=True)[0]) | {"camera_x_offset"})]


@pytest.mark.parametrize("name,key", CASE_KEYS)
def test_render_fused_camera_grads_match_jax(name, key):
    jgrads, tgrads, _ = results(name)
    assert set(tgrads) == set(jgrads)
    tol = CAMERA_TOL if key in POSE_KEYS else GRAD_TOL
    got, want = tgrads[key].numpy(), jgrads[key]
    if key in POSE_KEYS:
        assert np.abs(want).max() > 0.0, key
    assert_close_by_scale(got, want, tol, f"{name} {key}")


@pytest.mark.parametrize("name", list(SCENES))
def test_camera_grads_leave_the_other_gradients_bit_equal(name):
    _, with_camera, without = results(name)
    assert set(with_camera) == set(without) | set(POSE_KEYS)
    for key, want in without.items():
        assert torch.equal(with_camera[key], want), key


def test_split_scene_with_camera_has_the_jax_keys():
    jscene, tscene = make_scenes(vol_shape=VOL, lighting=True)
    diff, template = split_scene(tscene, with_camera=True)
    assert set(diff) == set(jax_split_scene(jscene, with_camera=True)[0])
    assert diff["camera_rotation"] is tscene.camera.rotation
    for key, value in (("camera_focal", 3.0), ("camera_distance", 6.0)):
        assert diff[key].shape == () and diff[key].dtype == torch.float32
        assert float(diff[key]) == value
    moved = merge_scene(template, {**diff, "camera_focal": diff["camera_focal"] * 2.0})
    assert float(moved.camera.focal_length) == 6.0
    assert moved.camera.rotation_host is None   # leaves: the key reads the device
    assert moved.camera.key()[9:] == (6.0, 6.0)


def test_scene_from_arrays_takes_intrinsics_as_leaves():
    """A number stays a Python float; a 0-d array becomes a 0-d float32
    tensor, and a render with it equals the render with the number."""
    jscene, tscene = make_scenes(vol_shape=VOL)
    arrays = arrays_of(jscene)
    arrays.update(focal_length=np.asarray(3.0, np.float32),
                  distance_to_object=np.asarray(6.0, np.float32))
    leafy = scene_from_arrays(arrays, device="cpu")
    assert isinstance(tscene.camera.focal_length, float)
    for value in (leafy.camera.focal_length, leafy.camera.distance_to_object):
        assert isinstance(value, torch.Tensor) and value.shape == ()
    opts = tscene.options(W, H)
    assert torch.equal(render_forward(leafy, opts, X_OFFSET),
                       render_forward(tscene, opts, X_OFFSET))
    assert leafy.camera.key() == tscene.camera.key()


# ---- the port's fused path against its own scan through autograd ----------
SMALL_W, SMALL_H = 24, 20


def small_scene(vol_shape):
    return make_scenes(vol_shape=vol_shape)[1]


def scan_loss(scene, opts, target, rotation):
    s = scene.replace(camera=scene.camera.replace(rotation=rotation))
    return torch.mean((render_forward(s, opts, differentiable=True) - target) ** 2)


def fused_loss(scene, opts, target, rotation):
    s = scene.replace(camera=scene.camera.replace(rotation=rotation))
    return torch.mean((render_fused(s, opts, camera_grads=True) - target) ** 2)


def test_camera_rotation_gradients_finite_nonzero():
    scene = small_scene((12, 10, 8))
    opts = scene.options(SMALL_W, SMALL_H)
    target = render_forward(scene, opts)
    rotation = (scene.camera.rotation + 0.03).requires_grad_(True)
    scan_loss(scene, opts, target, rotation).backward()
    assert torch.isfinite(rotation.grad).all() and rotation.grad.any()


def test_camera_grads_through_fused_replay_match_scan():
    scene = small_scene((12, 10, 8))
    opts = scene.options(SMALL_W, SMALL_H)
    target = render_forward(scene, opts)
    grads = []
    for loss in (scan_loss, fused_loss):
        rotation = (scene.camera.rotation + 0.03).requires_grad_(True)
        loss(scene, opts, target, rotation).backward()
        grads.append(rotation.grad.numpy())
    g_scan, g_fused = grads
    # the JAX package's bound for its fused path against its scan
    rel = np.abs(g_fused - g_scan).max() / np.abs(g_scan).max()
    assert rel < 5e-3, rel


def test_fused_intrinsics_gradients_match_scan():
    """d/d(focal, distance, x offset) of the fixed-trip replay against
    autograd of the fixed-trip march, which shares its convention (masks and
    the termination not differentiated)."""
    scene = small_scene((12, 10, 8))
    opts = scene.options(SMALL_W, SMALL_H)
    g = torch.from_numpy(
        (np.random.RandomState(3).randn(SMALL_H, SMALL_W, 3) * 1e-2).astype(np.float32))

    def grads(render):
        leaves = [torch.tensor(v, requires_grad=True) for v in (3.0, 6.0, 0.05)]
        s = scene.replace(camera=scene.camera.replace(focal_length=leaves[0],
                                                      distance_to_object=leaves[1]))
        torch.sum(g * render(s, leaves[2])).backward()
        return [float(leaf.grad) for leaf in leaves]

    got = grads(lambda s, x: render_fused(s, opts, x, camera_grads=True, early_exit=False))
    ref = grads(lambda s, x: render_rows(s, opts, x, 0, opts.height, differentiable=True))
    for name, a, b in zip(("camera_focal", "camera_distance", "camera_x_offset"), got, ref):
        assert np.isfinite(a) and b != 0.0, name
        # the JAX package's bound (tests/test_camera_grad.py)
        assert abs(a - b) <= 2e-3 * max(abs(a), abs(b)), f"{name}: fused={a:.6g} scan={b:.6g}"


def test_replay_backward_camera_grads_on_a_band():
    """A band's camera gradients plus the rest's equal the whole image's: the
    pull-back of a row depends on that row alone."""
    scene = small_scene((12, 10, 8))
    opts = scene.options(SMALL_W, SMALL_H)
    g = torch.from_numpy(
        (np.random.RandomState(4).randn(SMALL_H, SMALL_W, 3) * 1e-2).astype(np.float32))
    img = render_forward(scene, opts, X_OFFSET)

    def pose(y0, rows):
        out = replay_backward(scene, opts, g[y0:y0 + rows], img[y0:y0 + rows], X_OFFSET,
                              y0, rows, camera_grads=True)
        return {key: out[key] for key in POSE_KEYS}

    whole = pose(0, SMALL_H)
    top, rest = pose(0, 7), pose(7, SMALL_H - 7)
    for key, want in whole.items():
        assert_close_by_scale((top[key] + rest[key]).numpy(), want.numpy(), 1e-5, key)


def adam_fit(loss_fn, params, lr, steps):
    """(first loss, last loss) of ``steps`` Adam steps on ``params``."""
    optimizer = torch.optim.Adam(list(params.values()), lr=lr)
    first = None
    for _ in range(steps):
        optimizer.zero_grad()
        loss = loss_fn(params)
        loss.backward()
        optimizer.step()
        first = float(loss.detach()) if first is None else first
    with torch.no_grad():
        return first, float(loss_fn(params))


def test_pose_optimization_through_fused_replay():
    """A perturbed rotation descends back toward the target pose through the
    replay's camera gradients (the JAX package's test, 30 Adam steps)."""
    scene = small_scene((14, 12, 10))
    opts = scene.options(SMALL_W, SMALL_H)
    target = render_forward(scene, opts)
    truth = scene.camera.rotation
    noise = torch.from_numpy(0.02 * np.random.RandomState(0).randn(3, 3).astype(np.float32))
    params = {"rotation": (truth + noise).requires_grad_(True)}
    e0 = float(torch.sum((params["rotation"].detach() - truth) ** 2))
    l0, l1 = adam_fit(lambda p: fused_loss(scene, opts, target, p["rotation"]), params,
                      2e-3, 30)
    e1 = float(torch.sum((params["rotation"].detach() - truth) ** 2))
    assert l1 < 0.5 * l0, (l0, l1)
    assert e1 < e0, (e0, e1)


def test_joint_pose_and_intrinsics_recovery():
    """Perturbed (rotation, focal, distance) descend back toward the target
    through split_scene(with_camera=True) and render_fused (12 Adam steps)."""
    scene = small_scene((14, 12, 10))
    opts = scene.options(SMALL_W, SMALL_H)
    target = render_fused(scene, opts)
    diff0, template = split_scene(scene, with_camera=True)
    truth = {k: diff0[k] for k in ("camera_rotation", "camera_focal", "camera_distance")}
    params = {"camera_rotation": (truth["camera_rotation"] + 0.02).requires_grad_(True),
              "camera_focal": (truth["camera_focal"] + 0.15).requires_grad_(True),
              "camera_distance": (truth["camera_distance"] - 0.2).requires_grad_(True)}

    def loss(p):
        s = merge_scene(template, {**diff0, **p})
        return torch.mean((render_fused(s, opts, camera_grads=True) - target) ** 2)

    def err(p):
        return sum(float(torch.sum((p[k].detach() - truth[k]) ** 2)) for k in truth)

    e0 = err(params)
    l0, l1 = adam_fit(loss, params, 5e-3, 12)
    assert l1 < l0, (l0, l1)
    assert err(params) < e0
