"""The port's ``VolumeRenderer`` against the committed goldens and the JAX
facade: the five golden configurations, stereo, volume dedup and the
default reflection volume."""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import volume_renderer_tpu.api.renderer as jax_renderer_mod
from volume_renderer_tpu.api.planner import RenderPlan as JaxPlan
from volume_renderer_tpu.models.lights import LightSource as JLight
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.ops.hg import henyey_greenstein_lut as jax_hg

from volume_renderer_tpu_torch import (
    LightSource,
    StereoRenderMode,
    Volume,
    VolumeRenderer,
    henyey_greenstein_lut,
)

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
W, H = 24, 20
NAMES = ["pr1_plain", "example1_otf", "example1_grad", "example3_two_channel", "example2_stereo"]

PORT = SimpleNamespace(
    renderer=lambda: VolumeRenderer(device="cpu"),
    volume=lambda a: Volume.create(a, device="cpu"),
    light=LightSource, lut=lambda n: henyey_greenstein_lut(n, device="cpu"),
    stereo=StereoRenderMode.RED_CYAN, asnp=lambda x: x.numpy())
JAX = SimpleNamespace(
    renderer=jax_renderer_mod.VolumeRenderer, volume=JVolume.create, light=JLight, lut=jax_hg,
    stereo=jax_renderer_mod.StereoRenderMode.RED_CYAN, asnp=np.asarray)


def _vols(n=18):
    """The golden scenes' volumes (tests/test_goldens.py)."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    c = (n - 1) / 2.0
    r2 = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) / c
    em = np.exp(-6.0 * (r2 - 0.55) ** 2).astype(np.float32)
    structure = (np.exp(-8.0 * ((x - c) / c) ** 2)
                 * np.exp(-4.0 * (r2 - 0.3) ** 2)).astype(np.float32)
    return em, structure


def _base(lib, em):
    r = lib.renderer()
    r.volume_emission = lib.volume(em)
    r.volume_absorption = lib.volume(em * 0.8)
    r.focal_length = 3.0
    r.distance_to_object = 6.0
    r.rotate(125, 25, 0)
    r.image_resolution = (W, H)
    return r


def render_config(lib, name):
    """One golden configuration rendered through ``lib``'s facade, as numpy."""
    em, structure = _vols()
    r = _base(lib, em)
    if name in ("example1_otf", "example1_grad"):
        r.volume_reflection = lib.volume(em)
        r.volume_illumination = lib.lut(16)
        r.light_sources = [lib.light([5, 8, -4], [1.0, 0.7, 0.4])]
    if name == "example1_grad":
        r.volume_gradient_x, r.volume_gradient_y, r.volume_gradient_z = (
            lib.volume(em).gradient_volumes())
        r.factor_emission, r.factor_absorption, r.factor_reflection = 1.2, 0.7, 0.5
    if name == "example3_two_channel":
        r.color = (1.0, 0.3, 1.0)
        r2 = _base(lib, structure)
        r2.color = (0.3, 1.0, 0.3)
        return lib.asnp(r.render()) + lib.asnp(r2.render())
    if name == "example2_stereo":
        r.camera_x_offset = 0.25
        r.stereo_output = lib.stereo
    return lib.asnp(r.render())


@pytest.mark.parametrize("name", NAMES)
def test_goldens(name):
    # The goldens came from the JAX Pallas kernel, whose closed-form sample
    # positions differ slightly from the accumulated ones the port (and
    # the JAX plain path) uses, hence the looser tolerance.
    got = render_config(PORT, name)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    assert got.shape == golden.shape == (H, W, 3)
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_matches_jax_facade_on_flat_path(name, monkeypatch):
    monkeypatch.setattr(jax_renderer_mod, "plan_render",
                        lambda scene, opts, **kw: JaxPlan("flat"))
    want = render_config(JAX, name)
    got = render_config(PORT, name)
    # The render_forward tolerance of tests/test_torch_march.py, except for
    # the lit scenes: inside this symmetric shell the emission gradient
    # nearly vanishes, so the normal's direction rests on the last bits of
    # the six taps, where XLA and torch round differently; the shading is
    # not scaled by tstep and carries that through. Measured max abs error
    # 9.3e-6 on a pixel of 0.0447 (example1_otf).
    atol, rtol = (3e-5, 3e-4) if name.startswith("example1") else (1e-6, 1e-5)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_stereo_left_right_horizontal():
    em, _ = _vols()
    r = _base(PORT, em)
    r.camera_x_offset = 0.3
    r.stereo_output = StereoRenderMode.LEFT_RIGHT_HORIZONTAL
    img = r.render()
    assert img.shape == (H, 2 * W, 3)
    assert r.last_plan.path == "plain"


def test_volume_dedup_and_default_reflection():
    em, structure = _vols()
    r = _base(PORT, em)
    r.volume_absorption = Volume.create(em.copy(), device="cpu")  # equal values, new tensor
    scene = r._build_scene()
    assert scene.absorption_aliased
    assert scene.reflection.data.shape == (1, 1, 1)  # the default Volume(1)
    assert float(scene.reflection.data) == 1.0
    r.volume_reflection = Volume.create(em.copy(), device="cpu")
    r.volume_absorption = Volume.create(structure, device="cpu")
    scene = r._build_scene()
    assert scene.reflection_aliased and not scene.absorption_aliased
    # same shape, one voxel different: not equal
    other = em.copy()
    other[3, 4, 5] += 1.0
    r.volume_reflection = Volume.create(other, device="cpu")
    assert not r._build_scene().reflection_aliased


def test_facade_validation_and_later_slices():
    em, _ = _vols()
    r = PORT.renderer()
    with pytest.raises(ValueError, match="volumes"):
        r._build_scene()
    r = _base(PORT, em)
    r.volume_gradient_x = Volume.create(em, device="cpu")
    with pytest.raises(ValueError, match="gradient"):
        r.render()
    r.reset_gradient_volumes()
    r.mesh = object()  # a mesh is a list of devices (parallel.mesh.make_mesh)
    with pytest.raises(ValueError, match="mesh"):
        r.render()
    assert "total (deduplicated)" in r.mem_info()
    with pytest.raises(ValueError, match="backend"):
        VolumeRenderer(device="cpu", backend="oracles")
    r = PORT.renderer()
    with pytest.raises(ValueError, match="image_resolution"):
        r.render()


def test_normalize_helpers_match_jax():
    rng = np.random.default_rng(5)
    img = rng.random((6, 5, 3)).astype(np.float32) - 0.2
    seq = rng.random((4, 3, 3, 2)).astype(np.float32)
    jr = jax_renderer_mod.VolumeRenderer
    np.testing.assert_allclose(VolumeRenderer.normalize_image(img).numpy(),
                               np.asarray(jr.normalize_image(img)), rtol=1e-6)
    np.testing.assert_allclose(VolumeRenderer.normalize_image(img, 0.0, 2.0).numpy(),
                               np.asarray(jr.normalize_image(img, 0.0, 2.0)), rtol=1e-6)
    np.testing.assert_allclose(VolumeRenderer.normalize_sequence(seq).numpy(),
                               np.asarray(jr.normalize_sequence(seq)), rtol=1e-6)
    with pytest.raises(ValueError):
        VolumeRenderer.normalize_sequence(img)
