"""The port's ``voxel_grads_fast`` and ``transfer_grads_fast`` on the CPU
(their plain version, the replay with the kernel's angle adjoint) against
``jax.vjp`` of the JAX package's ``render_fused``: the replay that the JAX
package's own kernel tests (``tests/test_pallas.py``, marked slow, Pallas in
interpret mode) hold ``voxel_grads_fast`` against, with their cases.
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
from volume_renderer_tpu_torch.ops import cuda_grads, cuda_march
from volume_renderer_tpu_torch.ops.cuda_grads import transfer_grads_fast, voxel_grads_fast
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.ops.vjp import replay_backward

torch.set_num_threads(1)

VOL = (14, 14, 14)

# name: (scene arguments, (W, H), seed of the cotangent, camera_x_offset)
CASES = {
    "unlit_separate": (dict(rotate=(125.0, 25.0, 0.0)), (32, 32), 1, 0.0),
    "unlit_aliased": (dict(rotate=(125.0, 25.0, 0.0), alias_absorption=True), (32, 32), 1, 0.0),
    "unlit_tilted_wide": (dict(vol_shape=(13, 13, 13), rotate=(200.0, 160.0, 80.0)),
                          (40, 30), 2, 0.25),
    "lit_base": (dict(lighting=True, rotate=(125.0, 25.0, 0.0)), (32, 32), 7, 0.0),
    "lit_aliased_lut32": (dict(lighting=True, rotate=(125.0, 25.0, 0.0), alias_absorption=True,
                               alias_reflection=True, lut_size=32), (32, 32), 7, 0.0),
    "lit_two_lights": (dict(lighting=True, rotate=(125.0, 25.0, 0.0), n_lights=2),
                       (32, 32), 7, 0.0),
    "lit_tilted": (dict(lighting=True, rotate=(200.0, 160.0, 80.0)), (32, 32), 7, 0.0),
}

# Share of each gradient's largest magnitude. Unlit, both sides compute one
# function: measured at most 4.0e-6. Lit, the fast entry points floor
# 1 - r^2 of the angle adjoint at 1e-6 where jax.vjp of the JAX replay takes
# gradient zero beyond |r| >= 1 - 1e-6; the JAX package allows its own
# kernel 7e-3 against that replay (tests/test_pallas.py). On these blob
# volumes few normals meet a light or view direction that closely:
# measured at most 4.3e-5 (factor_reflection, everything aliased).
TOL = {False: 5e-5, True: 1e-3}
TRANSFER_KEYS = ("factor_emission", "factor_absorption", "factor_reflection", "color",
                 "light_colors")
# the cases that also go through transfer_grads_fast (a second replay each)
TRANSFER_CASES = ("unlit_separate", "unlit_aliased", "lit_base", "lit_two_lights")


def scenes_of(name):
    scene_kw, (w, h), seed, offset = CASES[name]
    jscene, tscene = make_scenes(**{"vol_shape": VOL, **scene_kw})
    g = (np.random.RandomState(seed).randn(h, w, 3) * 1e-3).astype(np.float32)
    return jscene, tscene, (w, h), g, offset


@functools.lru_cache(maxsize=None)
def results(name):
    """(jax image, jax grads, port image, port voxel grads, port transfer grads)."""
    jscene, tscene, (w, h), g, offset = scenes_of(name)
    jopts = jscene.options(w, h)
    diff, template = jax_split_scene(jscene)
    jimg, vjp_fn = jax.vjp(
        lambda d: jax_render_fused(jax_merge_scene(template, d), jopts, offset), diff)
    jgrads = {k: np.asarray(v) for k, v in vjp_fn(jnp.asarray(g))[0].items()}

    topts = tscene.options(w, h)
    before = dict(cuda_march.LAUNCHES_BY_MODE)
    timg, vgrads = voxel_grads_fast(tscene, topts, g, offset)
    tgrads = {}
    if name in TRANSFER_CASES:
        timg2, tgrads = transfer_grads_fast(tscene, topts, torch.from_numpy(g), offset,
                                            image=timg)
        assert timg2 is timg
    assert cuda_march.LAUNCHES_BY_MODE == before  # on the CPU no kernel launch is counted
    return (np.asarray(jimg), jgrads, timg.numpy(), {k: v.numpy() for k, v in vgrads.items()},
            {k: v.numpy() for k, v in tgrads.items()})


def rel_err(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def all_keys(scene_kw):
    keys = ["emission", "factor_emission", "factor_absorption", "factor_reflection", "color"]
    if not scene_kw.get("alias_absorption"):
        keys.append("absorption")
    if not scene_kw.get("alias_reflection"):
        keys.append("reflection")
    if scene_kw.get("lighting"):
        keys.append("light_colors")
    return sorted(keys)


CASE_KEYS = [(name, key) for name, case in CASES.items() for key in all_keys(case[0])]


@pytest.mark.parametrize("name", list(CASES))
def test_image_and_key_sets_match_jax(name):
    jimg, jgrads, timg, vgrads, tgrads = results(name)
    np.testing.assert_allclose(timg, jimg, atol=5e-6, rtol=1e-5)  # measured 3.7e-7
    assert set(vgrads) == set(jgrads) == set(all_keys(CASES[name][0]))
    if name in TRANSFER_CASES:
        assert set(tgrads) == set(jgrads) & set(TRANSFER_KEYS)


@pytest.mark.parametrize("name,key", CASE_KEYS)
def test_voxel_grads_fast_matches_jax_replay(name, key):
    _, jgrads, _, vgrads, _ = results(name)
    lit = CASES[name][0].get("lighting", False)
    err = rel_err(vgrads[key], jgrads[key])
    assert err <= TOL[lit], f"{name} {key}: {err:.3e} of the gradient's scale"


@pytest.mark.parametrize("name", TRANSFER_CASES)
def test_transfer_grads_fast_matches_jax_replay(name):
    _, jgrads, _, vgrads, tgrads = results(name)
    lit = CASES[name][0].get("lighting", False)
    for key, got in tgrads.items():
        np.testing.assert_array_equal(got, vgrads[key])  # one replay behind both
        err = rel_err(got, jgrads[key])
        assert err <= TOL[lit], f"{name} {key}: {err:.3e} of the gradient's scale"


def test_unlit_reflection_volume_gets_a_zero_gradient():
    _, _, _, vgrads, _ = results("unlit_separate")
    assert vgrads["reflection"].shape == VOL and not vgrads["reflection"].any()
    assert float(vgrads["factor_reflection"]) == 0.0


def test_image_reuse_equals_own_render():
    _, tscene, (w, h), g, offset = scenes_of("lit_two_lights")
    opts = tscene.options(w, h)
    img0 = render_forward_fast(tscene, opts, offset)
    img, grads = voxel_grads_fast(tscene, opts, g, offset, image=img0)
    assert img is img0
    _, _, _, vgrads, _ = results("lit_two_lights")
    for key, want in vgrads.items():
        np.testing.assert_array_equal(grads[key].numpy(), want)


def test_cpu_path_is_the_replay_with_the_floored_angle_adjoint():
    _, tscene, (w, h), g, offset = scenes_of("lit_base")
    opts = tscene.options(w, h)
    img, grads = voxel_grads_fast(tscene, opts, g, offset)
    want = replay_backward(tscene, opts, torch.from_numpy(g), img, offset, angle_floor=True)
    assert set(grads) == set(want)
    for key in want:
        np.testing.assert_array_equal(grads[key].numpy(), want[key].numpy())


@pytest.mark.parametrize("entry", [voxel_grads_fast, transfer_grads_fast])
def test_lit_lookup_scene_raises(entry):
    _, tscene = make_scenes(vol_shape=VOL, lighting=True, gradient_volumes=True)
    opts = tscene.options(16, 16)
    with pytest.raises(NotImplementedError, match="render_fused"):
        entry(tscene, opts, np.zeros((16, 16, 3), np.float32))


def test_march_backward_refuses_cpu_scenes():
    _, tscene = make_scenes(vol_shape=VOL)
    opts = tscene.options(16, 16)
    z = torch.zeros(16, 16, 3)
    with pytest.raises(ValueError, match="CUDA kernel"):
        cuda_grads.march_backward(tscene, opts, z, z)


def test_grad_mode():
    unlit, lit = make_scenes(vol_shape=VOL)[1], make_scenes(vol_shape=VOL, lighting=True)[1]
    assert cuda_grads.grad_mode(unlit, scatter=True) == "K3"
    assert cuda_grads.grad_mode(lit, scatter=True) == "K6"
    assert cuda_grads.grad_mode(unlit, scatter=False) == "K2"
    assert cuda_grads.grad_mode(lit, scatter=False) == "K2"
    assert set(cuda_march.LAUNCHES_BY_MODE) == {
        "K1", "K2", "K3", "K4", "K5", "K6", "K7_transmittance", "K7_segment", "K7_scatter"}
