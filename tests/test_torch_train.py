"""The port's training steps against the JAX package's ``train.train_step``
with the same optimizer from ``optax``, on the CPU.

Parameters cross as numpy (``params_from_arrays``); the target is the JAX
render of the unperturbed scene for both sides.
"""

from __future__ import annotations

import functools

import numpy as np
import optax
import pytest
import torch

from volume_renderer_tpu import train as jax_train
from volume_renderer_tpu.ops.forward import render_forward as jax_render_forward

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.convert import params_from_arrays
from volume_renderer_tpu_torch.ops import cuda_march
from volume_renderer_tpu_torch.ops.forward import render_forward

torch.set_num_threads(1)

W = H = 32
SCENE = dict(vol_shape=(14, 14, 14), rotate=(125.0, 25.0, 0.0))
# The gradients of this loss are about 1e-4: at a rate of 1e-2 an SGD update
# would vanish below the float32 spacing of the parameters and the
# comparison would hold whatever the gradients. At 10 the step is visible.
SGD_LR = 10.0


def perturbed(params):
    out = dict(params)
    out["emission"] = out["emission"] * 1.3 + 0.05
    return out


@functools.lru_cache(maxsize=None)
def jax_run(optimizer_name, n_steps):
    """Losses and final parameters of ``n_steps`` JAX train steps."""
    jscene, _ = make_scenes(**SCENE)
    opts = jscene.options(W, H)
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
    jscene, tscene = make_scenes(lighting=lighting, **SCENE)
    start = perturbed({k: np.asarray(v) for k, v in jax_train.split_params(jscene)[0].items()})
    params = params_from_arrays(start, device="cpu")
    opt = {"sgd": lambda p: torch.optim.SGD(p, lr=SGD_LR),
           "adam": lambda p: torch.optim.Adam(p, lr=1e-3)}[optimizer_name](list(params.values()))
    opts = tscene.options(W, H)
    losses = [float(step_fn(params, opt, tscene, opts, torch.from_numpy(target.copy())))
              for _ in range(n_steps)]
    return losses, {k: v.detach().numpy() for k, v in params.items()}


# One SGD step: the update is the rate times the gradient, which agrees with
# JAX's to 1e-5 of its scale (test_torch_vjp.py). The JAX package holds its
# own fast step to rtol=5e-4, atol=1e-7 of its replay step. Measured here:
# loss relative 8.7e-7; after updates of up to 0.16 (factor_absorption) and
# 3.3e-4 (emission) the parameters differ by at most 1.5e-7, one float32
# spacing of their values.
@pytest.mark.parametrize("step", ["train_step", "train_step_fast"])
def test_one_sgd_step_matches_jax(step):
    jlosses, jparams, target = jax_run("sgd", 1)
    losses, params = torch_run(getattr(train, step), "sgd", 1, target)
    assert abs(losses[0] - jlosses[0]) / jlosses[0] < 1e-5
    assert set(params) == set(jparams)
    for key, want in jparams.items():
        np.testing.assert_allclose(params[key], want, rtol=2e-6, atol=3e-7, err_msg=key)


# Adam divides the gradient by its running magnitude, so a voxel whose
# gradient is rounding noise around eps=1e-8 may move by a share of lr=1e-3
# in either direction: hence atol = 2e-5. Measured after three steps: the
# parameters differ by at most 7.2e-7, the losses by 1.4e-6 relative.
@pytest.mark.parametrize("step", ["train_step", "train_step_fast"])
def test_three_adam_steps_match_jax(step):
    jlosses, jparams, target = jax_run("adam", 3)
    losses, params = torch_run(getattr(train, step), "adam", 3, target)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[2] < losses[0]
    for key, want in jparams.items():
        np.testing.assert_allclose(params[key], want, rtol=1e-4, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("lighting", [False, True])
def test_train_step_fast_matches_train_step(lighting):
    """The two steps differ only in the angle adjoint of a lit scene; the
    tolerance is the one the JAX package holds its own pair to."""
    _, _, target = jax_run("sgd", 1)
    l_fast, p_fast = torch_run(train.train_step_fast, "sgd", 1, target, lighting)
    l_ref, p_ref = torch_run(train.train_step, "sgd", 1, target, lighting)
    assert abs(l_fast[0] - l_ref[0]) / l_ref[0] < 1e-6
    for key, want in p_ref.items():
        np.testing.assert_allclose(p_fast[key], want, rtol=5e-4, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("lighting", [False, True])
def test_loss_falls_over_five_fast_steps(lighting):
    _, tscene = make_scenes(lighting=lighting, n_lights=2, **SCENE)
    opts = tscene.options(W, H)
    target = render_forward(tscene, opts)
    params, static_scene = train.split_params(tscene)
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
    opt = torch.optim.Adam(list(params.values()), lr=3e-3)
    before = dict(cuda_march.LAUNCHES_BY_MODE)
    losses = [float(train.train_step_fast(params, opt, static_scene, opts, target))
              for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[0] > 0
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < 0.7 * losses[0], losses
    assert cuda_march.LAUNCHES_BY_MODE == before  # CPU scene: the plain versions ran


@pytest.mark.parametrize("alias_absorption", [False, True])
def test_split_merge_params_round_trip(alias_absorption):
    jscene, tscene = make_scenes(alias_absorption=alias_absorption, lighting=True, **SCENE)
    jparams, _ = jax_train.split_params(jscene)
    params, static_scene = train.split_params(tscene)
    assert set(params) == set(jparams)
    assert ("absorption" in params) == (not alias_absorption)
    for key, p in params.items():
        assert p.is_leaf and p.requires_grad and p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(jparams[key]))
    assert params["emission"].data_ptr() != tscene.emission.data.data_ptr()  # own storage
    merged = train.merge_params(params, static_scene)
    assert merged.emission.data is params["emission"]
    assert merged.settings.color is params["color"]
    assert merged.settings.opacity_threshold is tscene.settings.opacity_threshold
    assert merged.reflection is tscene.reflection and merged.camera is tscene.camera
    assert (merged.absorption is None) == alias_absorption


def test_params_from_arrays():
    jscene, _ = make_scenes(**SCENE)
    arrays = {k: np.asarray(v) for k, v in jax_train.split_params(jscene)[0].items()}
    params = params_from_arrays(arrays, device="cpu")
    assert set(params) == set(arrays)
    for key, p in params.items():
        assert p.is_leaf and p.requires_grad and p.device.type == "cpu"
        np.testing.assert_array_equal(p.detach().numpy(), arrays[key])
    with pytest.raises(KeyError, match="missing"):
        params_from_arrays({"emission": arrays["emission"]}, device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        params_from_arrays({**arrays, "light_colors": np.ones((1, 3))}, device="cpu")


def test_band_loss_scan_and_fused_agree():
    _, tscene = make_scenes(lighting=True, **SCENE)
    opts = tscene.options(W, H)
    target = render_forward(tscene, opts)[8:20] * 0.5
    grads = {}
    for impl in ("fused", "scan"):
        params, static_scene = train.split_params(tscene)
        loss = train.band_loss(params, static_scene, opts, target, 8, 12, impl=impl)
        loss.backward()
        grads[impl] = (float(loss.detach()), {k: p.grad.numpy() for k, p in params.items()})
    assert grads["fused"][0] == grads["scan"][0] > 0
    for key, want in grads["scan"][1].items():
        scale = float(np.abs(want).max())
        # the replay against autograd, as in test_torch_vjp.py (measured 9e-7)
        np.testing.assert_allclose(grads["fused"][1][key] / scale, want / scale, rtol=0,
                                   atol=2e-5, err_msg=key)
    with pytest.raises(ValueError, match="impl"):
        train.band_loss(params, static_scene, opts, target, 8, 12, impl="xla")
