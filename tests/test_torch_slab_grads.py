"""Gradients of the port's z-slab sweep on the CPU against the JAX
package's: ``render_fused_slabbed`` (the slab replay behind autograd),
``streamed_grads`` (host grids, with ``g`` and with ``g_fn``), one SGD step
of ``train_step_slabbed`` and of ``train_step_streamed``; and the card
sweep's backward (``ops/cuda_slab.py``, the K7 gradient segment's plain
pass over clamped windows) against ``voxel_grads_fast``.

Scenes are 16 x 12 x 10, images 16x12. Tolerances: against JAX
``rtol=2e-3, atol=2e-6`` (the JAX package's own, ``tests/test_slab_vjp.py``;
measured at most 1.2e-5 of each gradient's scale); the card sweep against
``voxel_grads_fast`` 1e-5 of scale (both replay with the kernels' angle
adjoint and accumulated positions; measured 7e-7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volume_renderer_tpu import train as jax_train
from volume_renderer_tpu.ops.forward import render_forward as jax_render
from volume_renderer_tpu.ops.slab import render_fused_slabbed as jax_fused_slabbed
from volume_renderer_tpu.ops.slab import streamed_grads as jax_streamed_grads
from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge
from volume_renderer_tpu.ops.vjp import split_scene as jax_split

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.ops import cuda_slab, slab
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.vjp import merge_scene, split_scene

torch.set_num_threads(1)

VOL = (16, 12, 10)
W, H = 16, 12
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)


def _cotangent(seed):
    return np.random.default_rng(seed).standard_normal((H, W, 3)).astype(np.float32) * 0.1


def _assert_grads(got, want, keys, tol=GRAD_TOL):
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), **tol,
                                   err_msg=key)


@pytest.mark.parametrize("kw,n", [
    (dict(rotate=(10.0, 5.0, 0.0)), 4),
    (dict(rotate=(88.0, 0.0, 0.0)), 4),
    (dict(rotate=(180.0, 20.0, 0.0), factors=(3.0, 0.4, 4.0), opacity_threshold=0.3), 4),
    (dict(lighting=True), 4),
    (dict(lighting=True, gradient_volumes=True, alias_absorption=True), 2),
    (dict(), 16),
], ids=["dz_positive", "dz_mixed", "dz_negative_early_termination", "lit_otf",
        "lit_lookup_aliased", "one_row_slabs"])
def test_render_fused_slabbed_grads_match_jax(kw, n):
    jscene, tscene = make_scenes(vol_shape=VOL, **kw)
    g = _cotangent(1)
    jdiff, jtemplate = jax_split(jscene)
    want = jax.grad(lambda d: jnp.sum(
        jax_fused_slabbed(jax_merge(jtemplate, d), jscene.options(W, H), n_slabs=n) * g))(jdiff)
    diff, template = split_scene(tscene)
    leaves = {k: v.clone().requires_grad_(True) for k, v in diff.items()}
    out = slab.render_fused_slabbed(merge_scene(template, leaves), tscene.options(W, H),
                                    n_slabs=n)
    (out * torch.from_numpy(g)).sum().backward()
    assert set(leaves) == set(want)
    _assert_grads({k: v.grad.numpy() for k, v in leaves.items()}, want, want.keys())


@pytest.mark.parametrize("kw", [dict(rotate=(88.0, 0.0, 0.0)), dict(lighting=True)],
                         ids=["unlit_dz_mixed", "lit_otf"])
def test_streamed_grads_match_jax(kw):
    jscene, tscene = make_scenes(vol_shape=VOL, **kw)
    host = jscene.replace(**{k: getattr(jscene, k).replace(data=np.asarray(getattr(jscene, k).data))
                             for k in ("emission", "absorption", "reflection")})
    g = _cotangent(2)
    want, want_img = jax_streamed_grads(host, jscene.options(W, H), g, n_slabs=4)
    got, img = slab.streamed_grads(tscene, tscene.options(W, H), torch.from_numpy(g), n_slabs=4,
                                   device="cpu")
    assert set(got) == set(want)
    # the sampled grids' gradients, in host memory
    grids = {"emission", "absorption"} | ({"reflection"} if tscene.has_lighting else set())
    assert grids <= set(got)
    for key in grids:
        assert got[key].device.type == "cpu" and got[key].shape == VOL
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=5e-4, atol=1e-5)
    _assert_grads({k: v.numpy() for k, v in got.items()}, want, want.keys())
    # g_fn: the cotangent from the streamed forward's own image
    by_fn, _ = slab.streamed_grads(tscene, tscene.options(W, H), None, n_slabs=4, device="cpu",
                                   g_fn=lambda image: torch.from_numpy(g) + 0.0 * image)
    for key, value in got.items():
        np.testing.assert_array_equal(by_fn[key].numpy(), value.numpy())


def _sgd_step_pair(step_name, n):
    """One SGD step of the JAX and the port's ``step_name`` from the same
    perturbed parameters: ((loss, new params, grads) of each)."""
    jscene, tscene = make_scenes(vol_shape=VOL, rotate=(88.0, 0.0, 0.0))
    opts = tscene.options(W, H)
    target = np.asarray(jax_render(jscene, jscene.options(W, H)))
    jparams, _ = jax_train.split_params(jscene)
    jparams = dict(jparams, emission=jparams["emission"] * 1.3 + 0.05)
    lr = 1e-2
    opt = optax.sgd(lr)
    if step_name == "slabbed":
        jloss, jgrads = jax.value_and_grad(jax_train.band_loss_slabbed)(
            jparams, jscene, jscene.options(W, H), target, n)
        jnew, _, _ = jax_train.train_step_slabbed(jparams, opt.init(jparams), jscene,
                                                  jscene.options(W, H), target, opt, n_slabs=n)
    else:
        jnew, _, jloss = jax_train.train_step_streamed(jparams, opt.init(jparams), jscene,
                                                       jscene.options(W, H), target, opt,
                                                       n_slabs=n)
        jgrads, _ = jax_streamed_grads(jax_train.merge_params(jparams, jscene),
                                       jscene.options(W, H), None, n_slabs=n,
                                       g_fn=lambda out: 2.0 * (out - target))
        jgrads = {k: jgrads[k] for k in jparams}
    params, static = train.split_params(tscene)
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
    optimizer = torch.optim.SGD(list(params.values()), lr=lr)
    step = train.train_step_slabbed if step_name == "slabbed" else train.train_step_streamed
    kw = {} if step_name == "slabbed" else dict(device="cpu")
    loss = step(params, optimizer, static, opts, torch.from_numpy(target.copy()), n_slabs=n,
                **kw)
    return ((float(jloss), {k: np.asarray(v) for k, v in jnew.items()}, jgrads),
            (float(loss), {k: v.detach().numpy() for k, v in params.items()},
             {k: v.grad.numpy() for k, v in params.items()}))


@pytest.mark.parametrize("step_name", ["slabbed", "streamed"])
def test_one_sgd_step_matches_jax(step_name):
    (jloss, jnew, jgrads), (loss, new, grads) = _sgd_step_pair(step_name, 4)
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(new) == set(jnew)
    _assert_grads(grads, jgrads, jgrads.keys())
    for key in new:
        np.testing.assert_allclose(new[key], jnew[key], rtol=1e-6, atol=1e-6, err_msg=key)


def _of_scale(got, want):
    return {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
            for k in want}


@pytest.mark.parametrize("kw,n", [
    (dict(rotate=(10.0, 5.0, 0.0)), 4),
    (dict(rotate=(180.0, 20.0, 0.0), alias_absorption=True), 4),
    (dict(rotate=(88.0, 0.0, 0.0)), 8),
    (dict(factors=(3.0, 0.4, 4.0), opacity_threshold=0.3), 4),
    (dict(), 16),
], ids=["dz_positive", "dz_negative_aliased", "dz_mixed", "early_termination",
        "one_row_slabs"])
def test_card_sweep_grads_match_voxel_grads_fast(kw, n):
    _, tscene = make_scenes(vol_shape=VOL, **kw)
    opts = tscene.options(W, H)
    g = torch.from_numpy(_cotangent(3))
    img, got = cuda_slab.voxel_grads_slabbed_fast(tscene, opts, g, n_slabs=n)
    want_img, want = voxel_grads_fast(tscene, opts, g)
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=0, atol=1e-7)
    assert set(got) == set(want)
    errs = _of_scale(got, want)
    assert max(errs.values()) < 1e-5, errs
    # through autograd (train_step_slabbed's route on a card)
    diff, template = split_scene(tscene)
    leaves = {k: v.clone().requires_grad_(True) for k, v in diff.items()}
    out = cuda_slab.render_fused_slabbed_fast(merge_scene(template, leaves), opts, n_slabs=n)
    (out * g).sum().backward()
    errs = _of_scale({k: v.grad for k, v in leaves.items()}, want)
    assert max(errs.values()) < 1e-5, errs
