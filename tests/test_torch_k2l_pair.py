"""K2L's paired form on the CPU: the pair of absorption and reflection that
it reads at the cell of K5's pack (``ops.cuda_grads.pack_lookup_pair``), the
host's choice of its form (``k2l_form``), the form counts, the plain K2L
(``transfer_grads_fast`` on the CPU) against the JAX package's replay, and
``chip_smoke.py``'s reading of K2L's kernels and block constant.

On a card K2L launches the form that ``k2l_form`` names (``chip_smoke.py``
holds each form against the plain replay and counts them); on the CPU every
form is the plain replay, ``ops.vjp.replay_backward``, so the JAX comparison
holds the function that all forms compute.

Scenes are 16^3, 24 x 20 images: ``make_scenes``' seeded lit scene times 5 %
seeded noise (``tests/test_torch_lookup_grads.py``, whose tolerance against
the JAX replay, ``TOL_JAX``, holds here too), the gradient volumes made from
the noisy emission, and one volume at half the height and width where a
case has one of another shape.
"""

from __future__ import annotations

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene

from test_torch_helpers import arrays_of, make_scenes
from test_torch_lookup_grads import LOOKUP_KEYS, NOISE, TOL_JAX, jax_scene_of, of_scale
from volume_renderer_tpu_torch.convert import scene_from_arrays
from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.ops import _build, cuda_grads, cuda_march
from volume_renderer_tpu_torch.ops.cuda_grads import transfer_grads_fast
from volume_renderer_tpu_torch.ops.vjp import replay_backward

torch.set_num_threads(1)

VOL = (16, 16, 16)
W, H = 24, 20
# name -> (make_scenes' keywords, the volume of another shape or None, K2L's form)
CASES = {
    "both_own": (dict(), None, "paired"),
    "both_own_two_lights": (dict(n_lights=2), None, "paired"),
    "absorption_aliased": (dict(alias_absorption=True), None, "unpaired"),
    "reflection_aliased": (dict(alias_reflection=True), None, "unpaired"),
    "absorption_other_shape": (dict(), "absorption", "unpaired"),
    "reflection_other_shape": (dict(), "reflection", "unpaired"),
    "gradients_other_shape": (dict(), "gradients", "unpacked"),
}


@functools.lru_cache(maxsize=None)
def scenes(name):
    """(JAX scene, port scene on the CPU) of a case, from numpy seeds."""
    kw, other, _ = CASES[name]
    jscene, _ = make_scenes(seed=18, vol_shape=VOL, lighting=True, rotate=(125.0, 25.0, 0.0),
                            **kw)
    a = arrays_of(jscene)
    u = np.random.default_rng(18).random(VOL, dtype=np.float32)
    factor = (np.float32(1.0) + np.float32(NOISE) * (u - np.float32(0.5))).astype(np.float32)
    for key in ("emission", "absorption", "reflection"):
        if a[key] is not None:
            a[key] = (a[key] * factor).astype(np.float32)
    src = a["emission"][:, ::2, ::2] if other == "gradients" else a["emission"]
    gradients = Volume.create(np.ascontiguousarray(src), device="cpu").gradient_volumes()
    a.update({key: v.data.numpy() for key, v in zip(LOOKUP_KEYS, gradients)})
    if other in ("absorption", "reflection"):
        a[other] = np.ascontiguousarray(a[other][:, ::2, ::2])
    return jax_scene_of(a), scene_from_arrays(a, device="cpu")


def cotangent():
    return (np.random.RandomState(18).randn(H, W, 3) * 1e-3).astype(np.float32)


# ---- the pair and the form -------------------------------------------------------


@pytest.mark.parametrize("name", ["both_own", "both_own_two_lights"])
def test_pair_is_absorption_and_reflection_side_by_side(name):
    _, scene = scenes(name)
    pair = cuda_grads.pack_lookup_pair(scene)
    ab, re_ = scene.absorption.data, scene.reflection.data
    assert pair.dtype == torch.float32 and pair.is_contiguous()
    assert tuple(pair.shape) == tuple(scene.emission.data.shape) + (2,)
    assert pair.data_ptr() % 8 == 0
    assert cuda_grads.PAIR_KEYS == ("absorption", "reflection")
    np.testing.assert_array_equal(pair[..., 0].numpy(), ab.numpy())
    np.testing.assert_array_equal(pair[..., 1].numpy(), re_.numpy())
    # a new grid a call, as unlit K2's pair: the volumes are not views of it
    assert pair.data_ptr() not in (ab.data_ptr(), re_.data_ptr())


@pytest.mark.parametrize("name", [n for n, case in CASES.items() if case[2] != "paired"])
def test_no_pair_where_the_kernel_samples_each_volume(name):
    _, scene = scenes(name)
    assert cuda_grads.pack_lookup_pair(scene) is None


@pytest.mark.parametrize("lit", [False, True])
def test_no_pair_without_lookup_gradients(lit):
    """An unlit scene and a lit one with on-the-fly gradients (lit K2) have
    no K2L form and no pair, though their absorption and reflection are
    separate and of emission's shape."""
    _, scene = make_scenes(seed=18, vol_shape=VOL, lighting=lit)
    assert not cuda_march.is_lookup(scene)
    assert scene.absorption.data.shape == scene.emission.data.shape
    assert cuda_grads.k2l_form(scene) is None
    assert cuda_grads.pack_lookup_pair(scene) is None


@pytest.mark.parametrize("name", list(CASES))
def test_the_form_k2l_launches(name):
    """paired beside K5's pack with absorption and reflection separate and of
    emission's shape; unpaired beside the pack otherwise; unpacked where the
    gradient volumes have another shape than emission's (no pack)."""
    _, scene = scenes(name)
    form = CASES[name][2]
    assert cuda_grads.k2l_form(scene) == form
    assert cuda_grads.grad_mode(scene, scatter=False) == "K2L"
    assert cuda_grads.has_pack(scene) == (form != "unpacked")
    assert (cuda_march.pack_lookup(scene) is None) == (form == "unpacked")
    assert (cuda_grads.pack_lookup_pair(scene) is not None) == (form == "paired")


def test_launches_are_counted_by_form():
    """count_launch counts a form beside its mode; a reset clears both."""
    saved = (dict(cuda_march.LAUNCHES_BY_MODE), dict(cuda_march.LAUNCHES_BY_FORM))
    try:
        cuda_march.reset_launch_counts()
        cuda_march.count_launch("K2L", "paired")
        cuda_march.count_launch("K2L", "paired")
        cuda_march.count_launch("K2L", "unpacked")
        cuda_march.count_launch("K5")
        assert cuda_march.LAUNCHES_BY_FORM == {"K2L paired": 2, "K2L unpacked": 1}
        assert cuda_march.LAUNCHES_BY_MODE["K2L"] == 3
        assert sum(cuda_march.LAUNCHES_BY_MODE.values()) == 4
        cuda_march.reset_launch_counts()
        assert cuda_march.LAUNCHES_BY_FORM == {}
        assert sum(cuda_march.LAUNCHES_BY_MODE.values()) == 0
    finally:
        cuda_march.LAUNCHES_BY_MODE.update(saved[0])
        cuda_march.LAUNCHES_BY_FORM.clear()
        cuda_march.LAUNCHES_BY_FORM.update(saved[1])


def test_march_backward_launches_only_on_a_card():
    """The wrapper that takes ``pair=`` launches the kernel; a CPU scene is
    refused there (its entry points run the plain replay instead)."""
    _, scene = scenes("both_own")
    opts = scene.options(W, H)
    g = torch.from_numpy(cotangent())
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        cuda_grads.march_backward(scene, opts, g, g, scatter=False,
                                  pair=cuda_grads.pack_lookup_pair(scene))


# ---- the plain K2L against the JAX package's replay ----------------------------------


@functools.lru_cache(maxsize=None)
def jax_transfer_grads(name):
    jscene, _ = scenes(name)
    diff, template = jax_split_scene(jscene)
    _, vjp_fn = jax.vjp(
        lambda d: jax_render_fused(jax_merge_scene(template, d), jscene.options(W, H)), diff)
    grads = vjp_fn(jnp.asarray(cotangent()))[0]
    return {k: np.asarray(grads[k]) for k in cuda_grads.PARAM_KEYS}


@pytest.mark.parametrize("name", ["both_own", "both_own_two_lights", "reflection_other_shape"])
def test_plain_k2l_matches_the_jax_replay(name):
    """``transfer_grads_fast`` on the CPU (the plain version of every K2L
    form, the paired one's scenes first) against ``jax.vjp`` of the JAX
    package's ``render_fused``, the XLA replay that its fast entry points
    send a lit lookup scene to, within ``TOL_JAX`` of each key's scale; and
    equal to the floored replay it is, to the bit."""
    jscene, scene = scenes(name)
    opts = scene.options(W, H)
    img, grads = transfer_grads_fast(scene, opts, cotangent())
    np.testing.assert_allclose(
        img.numpy(), np.asarray(jax_render_fused(jscene, jscene.options(W, H))),
        rtol=1e-5, atol=1e-6)
    want = jax_transfer_grads(name)
    assert set(grads) == set(want)
    errs = {k: of_scale(grads[k].numpy(), v) for k, v in want.items()}
    assert max(errs.values()) <= TOL_JAX, errs
    replay = replay_backward(scene, opts, torch.from_numpy(cotangent()), img, angle_floor=True)
    for key, value in grads.items():
        np.testing.assert_array_equal(value.numpy(), replay[key].numpy(), err_msg=key)


# ---- chip_smoke.py's reading of K2L -------------------------------------------------


def test_chip_smoke_reads_k2l_blocks():
    """kernel_threads reads K2L's own row constant (kK2LRows) for its packed
    and unpacked kernels, lit K2 keeps kK2LitRows; tail_factor takes K2L's
    block shape."""
    import chip_smoke

    source = (_build.CSRC_DIR / "march_bwd.cu").read_text()
    rows = {name: int(re.search(r"constexpr int %s = (\d+);" % name, source).group(1))
            for name in ("kK2LRows", "kK2LitRows")}
    threads = chip_smoke.kernel_threads(chip_smoke.REPO)
    assert threads["march_bwd_lookup_params_kernel"] == 16 * rows["kK2LRows"]
    assert threads["march_bwd_lookup_unpacked_params_kernel"] == 16 * rows["kK2LRows"]
    assert threads["march_bwd_lit_params_kernel"] == 16 * rows["kK2LitRows"]
    r = rows["kK2LRows"]
    steps = torch.zeros((2 * r, 32), dtype=torch.int32)
    steps[0, 0] = steps[r, 0] = 8  # one ray of 8 samples in each of two 16 x r blocks
    assert chip_smoke.tail_factor(steps, 16, r) == 16 * r
