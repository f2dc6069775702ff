"""The port's ``render_oracle`` (the per-pixel reference march) and the
facade's ``backend="oracle"`` against the JAX package's, and against the
port's own ``render_forward``."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import volume_renderer_tpu.api.renderer as jax_renderer_mod
from volume_renderer_tpu.ops.oracle import render_oracle as jax_render_oracle

from test_torch_facade import JAX, NAMES, PORT, render_config
from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch import VolumeRenderer, render_oracle
from volume_renderer_tpu_torch.ops.forward import render_forward

torch.set_num_threads(1)

W, H = 24, 20
VOL = (14, 16, 18)

CASES = {
    "unlit": (dict(), 0.0),
    "lit_otf": (dict(lighting=True, n_lights=2), 0.0),
    "lit_lookup": (dict(lighting=True, gradient_volumes=True, factors=(1.2, 0.5, 0.7)), 0.0),
    "stereo_offset": (dict(alias_absorption=True), 0.2),
    "threshold_exit": (dict(factors=(1.0, 0.4, 40.0), opacity_threshold=0.5), 0.0),
}


def bounds(name):
    """The facade's bounds (tests/test_torch_facade.py): lit, the normal's
    direction rests on the last bits of the six taps, where XLA and torch
    round differently."""
    return (3e-5, 3e-4) if name.startswith("lit") or name.startswith("example1") else (1e-6, 1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_render_oracle_matches_jax(name):
    scene_kw, x_offset = CASES[name]
    jscene, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    want = np.asarray(jax_render_oracle(jscene, jscene.options(W, H), x_offset))
    got = render_oracle(tscene, tscene.options(W, H), x_offset, device="cpu")
    assert got.shape == (H, W, 3) and got.device.type == "cpu"
    assert np.count_nonzero(want) > W
    atol, rtol = bounds(name)
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", list(CASES))
def test_render_oracle_equals_render_forward(name):
    """Two implementations of one march, the same float32 arithmetic: equal
    to the bit (render_forward's step cap is never reached)."""
    scene_kw, x_offset = CASES[name]
    _, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    opts = tscene.options(W, H)
    assert torch.equal(render_oracle(tscene, opts, x_offset, device="cpu"),
                       render_forward(tscene, opts, x_offset))


def test_render_oracle_band_is_the_image_rows():
    scene_kw, x_offset = CASES["lit_otf"]
    _, tscene = make_scenes(vol_shape=VOL, **scene_kw)
    opts = tscene.options(W, H)
    whole = render_oracle(tscene, opts, x_offset, device="cpu")
    band = render_oracle(tscene, opts, x_offset, device="cpu", y_offset=7, n_rows=9)
    assert torch.equal(band, whole[7:16])


def test_render_oracle_moves_the_scene_to_its_device():
    _, tscene = make_scenes(vol_shape=VOL)
    out = render_oracle(tscene, tscene.options(W, H), torch.tensor(0.1), device="cpu")
    assert torch.equal(out, render_forward(tscene, tscene.options(W, H), 0.1))


ORACLE_PORT = SimpleNamespace(**{**vars(PORT), "renderer": lambda: VolumeRenderer(
    device="cpu", backend="oracle")})
ORACLE_JAX = SimpleNamespace(**{**vars(JAX), "renderer": lambda: jax_renderer_mod.VolumeRenderer(
    backend="oracle")})


@pytest.mark.parametrize("name", NAMES)
def test_facade_oracle_backend_matches_jax(name):
    """The golden configurations, stereo among them, through both facades'
    oracle backends, which plan nothing."""
    want = render_config(ORACLE_JAX, name)
    got = render_config(ORACLE_PORT, name)
    atol, rtol = bounds(name)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    # and the port's forward backend, the same march
    np.testing.assert_array_equal(got, render_config(PORT, name))


def test_facade_oracle_backend_plans_nothing():
    r = ORACLE_PORT.renderer()
    r.volume_emission = r.volume_absorption = PORT.volume(np.ones((4, 4, 4), np.float32))
    r.image_resolution = (8, 6)
    r.focal_length, r.distance_to_object = 3.0, 6.0
    r.memory_budget_bytes = 1   # no tier would fit
    assert r.render().shape == (6, 8, 3)
    assert r.last_plan is None
