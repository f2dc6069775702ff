"""Gradients of lit scenes on the card's large-volume routes, on the CPU:
the lit gradient segment (``ops/cuda_bricks.py``, its plain pass on CPU
bricks) through ``parallel.bricks.voxel_grads_bricked_fast`` and
``train_step_fast_bricked`` and the card's slab sweep
(``ops.cuda_slab.voxel_grads_slabbed_fast``, ``render_fused_slabbed_fast``),
against the port's single-device ``voxel_grads_fast``, the JAX package's
single-device replay (``render_fused`` under ``jax.grad``) and its
``streamed_grads``; never against the JAX package's lit
``voxel_grads_bricked_fast``, whose lit gradients are wrong (ROADMAP §3).
Scenes, cases and tolerances are ``test_torch_lit_routes.py``'s.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.slab import streamed_grads as jax_streamed_grads
from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene

from test_torch_lit_routes import (
    CASES, GRAD_CASES, H, IMAGE_TOL, N, TOL_JAX_OF_SCALE, TOL_JAX_SWEEP_OF_SCALE, TOL_SINGLE, W,
    cotangent, of_scale, scenes, whole)
from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks, cuda_slab
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.forward import render_forward
from volume_renderer_tpu_torch.ops.vjp import merge_scene, split_scene
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


# ---- the gradients: the lit gradient segment -----------------------------------


@functools.lru_cache(maxsize=None)
def single_device_grads(name):
    _, tscene = scenes(name)
    g = torch.from_numpy(cotangent())
    return voxel_grads_fast(tscene, tscene.options(W, H), g)


@functools.lru_cache(maxsize=None)
def jax_single_device_grads(name):
    """jax.grad of the JAX package's single-device replay (``render_fused``)."""
    jscene, _ = scenes(name)
    diff, template = jax_split_scene(jscene)
    g = jnp.asarray(cotangent())
    opts = jscene.options(W, H)
    grads = jax.grad(lambda d: jnp.sum(
        jax_render_fused(jax_merge_scene(template, d), opts) * g))(diff)
    return {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("name", GRAD_CASES)
def test_lit_bricked_grads_match_single_device(name):
    """``voxel_grads_bricked_fast`` (phase 1, lit phase 2 and the lit
    gradient segment a brick, the halo rows folded back) against the port's
    single-device ``voxel_grads_fast`` and the JAX package's single-device
    replay: every key, the reflection grid and the light colors included."""
    _, tscene = scenes(name)
    opts = tscene.options(W, H)
    img, got = bricks.voxel_grads_bricked_fast(tscene, opts, cotangent(),
                                               mesh=make_mesh(N, "cpu"))
    want_img, want = single_device_grads(name)
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=0, atol=1e-7)
    assert set(got) == set(want)
    assert ("light_colors" in got) and (("reflection" in got) != bool(
        CASES[name].get("alias_reflection")))
    errs = {k: of_scale(whole(v).numpy(), want[k].numpy()) for k, v in got.items()}
    assert max(errs.values()) < TOL_SINGLE, errs
    jwant = jax_single_device_grads(name)
    errs = {k: of_scale(whole(got[k]).numpy(), jwant[k]) for k in jwant}
    assert max(errs.values()) < TOL_JAX_OF_SCALE, errs


@pytest.mark.parametrize("name", GRAD_CASES)
def test_lit_card_sweep_grads_match_single_device_and_jax_streamed_grads(name):
    """The card sweep's backward (the lit gradient segment a slab, the window
    gradients added into whole grids) against ``voxel_grads_fast``, through
    autograd (``render_fused_slabbed_fast``, ``train_step_slabbed``'s route on
    a card) too, and against the JAX package's ``streamed_grads``."""
    jscene, tscene = scenes(name)
    opts = tscene.options(W, H)
    g = cotangent()
    img, got = cuda_slab.voxel_grads_slabbed_fast(tscene, opts, torch.from_numpy(g), n_slabs=N)
    want_img, want = single_device_grads(name)
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=0, atol=1e-7)
    assert set(got) == set(want)
    errs = {k: of_scale(got[k].numpy(), want[k].numpy()) for k in want}
    assert max(errs.values()) < TOL_SINGLE, errs
    diff, template = split_scene(tscene)
    leaves = {k: v.clone().requires_grad_(True) for k, v in diff.items()}
    out = cuda_slab.render_fused_slabbed_fast(merge_scene(template, leaves), opts, n_slabs=N)
    (out * torch.from_numpy(g)).sum().backward()
    errs = {k: of_scale(v.grad.numpy(), want[k].numpy()) for k, v in leaves.items()}
    assert max(errs.values()) < TOL_SINGLE, errs
    host = jscene.replace(**{k: getattr(jscene, k).replace(data=np.asarray(getattr(jscene, k).data))
                             for k in ("emission", "absorption", "reflection")
                             if getattr(jscene, k) is not None})
    jgot, jimg = jax_streamed_grads(host, jscene.options(W, H), g, n_slabs=N)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **IMAGE_TOL)
    errs = {k: of_scale(got[k].numpy(), np.asarray(jgot[k])) for k in jgot}
    assert max(errs.values()) < TOL_JAX_SWEEP_OF_SCALE, errs


def test_lit_bricked_train_step_matches_train_step_fast():
    """One SGD step of ``train_step_fast_bricked`` on a lit scene, whole
    params and per-brick leaves, against ``train.train_step_fast``."""
    _, tscene = scenes("lit_otf")
    opts = tscene.options(W, H)
    target = render_forward(tscene, opts)
    lr = 1e-3

    def perturbed(params):
        with torch.no_grad():
            for p in (params["emission"] if isinstance(params["emission"], list)
                      else [params["emission"]]):
                p.mul_(1.05).add_(0.01)
        return params

    params, static = train.split_params(tscene)
    perturbed(params)
    want_loss = train.train_step_fast(params, torch.optim.SGD(list(params.values()), lr=lr),
                                      static, opts, target)
    whole_params, _ = train.split_params(tscene)
    perturbed(whole_params)
    loss = bricks.train_step_fast_bricked(
        whole_params, torch.optim.SGD(list(whole_params.values()), lr=lr), static, opts, target,
        mesh=make_mesh(N, "cpu"))
    cut, bstatic = bricks.split_params_bricked(tscene, make_mesh(N, "cpu"))
    perturbed(cut)
    cut_loss = bricks.train_step_fast_bricked(
        cut, torch.optim.SGD(bricks.param_leaves(cut), lr=lr), bstatic, opts, target)
    for got in (loss, cut_loss):
        np.testing.assert_allclose(float(got), float(want_loss), rtol=1e-6)
    for key, p in params.items():
        for got in (whole_params[key], whole(cut[key])):
            np.testing.assert_allclose(got.detach().numpy(), p.detach().numpy(),
                                       rtol=1e-6, atol=1e-8, err_msg=key)


def test_lit_lookup_gradient_segment_refuses():
    """The lookup gradient segment, which these entry points refused before
    it existed: on a CPU brick ``brick_gradients`` is the plain pass with the
    kernels' angle adjoint, to the bit, the three gradient windows' grids
    among its keys; the bricked and the card sweep's backward through it
    hold every key, the gradient volumes' too, within ``TOL_SINGLE`` of
    single-device ``voxel_grads_fast`` and within ``TOL_JAX_OF_SCALE`` of the
    JAX package's single-device replay."""
    _, tscene = scenes("lit_lookup")
    opts = tscene.options(W, H)
    g = torch.from_numpy(cotangent())
    brick = bricks.split_bricks(tscene, make_mesh(N, "cpu")).bricks[1]
    w, entry = cuda_bricks.brick_transmittance(brick, opts)
    image = render_forward(tscene, opts)
    got = cuda_bricks.brick_gradients(brick, opts, 0.0, g, image, w, w, entry)
    want = brick_march.replay_pass(brick, opts, 0.0, g, image, w, w, angle_floor=True,
                                   entry=entry)
    assert set(got) == set(want) and {"gradient_x", "gradient_y", "gradient_z"} <= set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)
    want_img, want = single_device_grads("lit_lookup")
    jwant = jax_single_device_grads("lit_lookup")
    for img, grads in (
            bricks.voxel_grads_bricked_fast(tscene, opts, g, mesh=make_mesh(N, "cpu")),
            cuda_slab.voxel_grads_slabbed_fast(tscene, opts, g, n_slabs=N)):
        np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=0, atol=1e-7)
        assert set(grads) == set(want) == set(jwant)
        errs = {k: of_scale(whole(v).numpy(), want[k].numpy()) for k, v in grads.items()}
        assert max(errs.values()) < TOL_SINGLE, errs
        errs = {k: of_scale(whole(grads[k]).numpy(), jwant[k]) for k in jwant}
        assert max(errs.values()) < TOL_JAX_OF_SCALE, errs
