"""The port's scene model against the JAX package's: render options, camera,
lights, HG LUT and volume ops, on the same numpy inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.models.camera import Camera as JCamera
from volume_renderer_tpu.models.lights import LightSource as JLight
from volume_renderer_tpu.models.lights import pack_lights as jax_pack_lights
from volume_renderer_tpu.models.scene import build_render_options as jax_options
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.ops.hg import henyey_greenstein_lut as jax_hg

from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.lights import LightSource, pack_lights
from volume_renderer_tpu_torch.models.scene import RenderSettings, build_render_options
from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.ops.hg import henyey_greenstein_lut

torch.set_num_threads(1)


@pytest.mark.parametrize("extent", [(32, 32, 32), (24, 16, 20), (17, 29, 5)])
@pytest.mark.parametrize("element_size", [(1.0, 1.0, 1.0), (0.7, 1.3, 2.5)])
def test_build_render_options_bit_equal(extent, element_size):
    got = build_render_options(extent, element_size, 64, 48)
    want = jax_options(extent, element_size, 64, 48)
    for field in ("width", "height", "boxmin", "boxmax", "tstep", "gradient_step", "n_steps"):
        assert getattr(got, field) == getattr(want, field), field
    assert hash(got) == hash(want)


@pytest.mark.parametrize("angles", [(125.0, 25.0, 0.0), (30.0, -20.0, 10.0), (-77.5, 191.0, 43.0),
                                    (0.0, 90.0, 0.0), (359.9, -0.001, 180.0)])
def test_camera_rotate(angles):
    start = np.asarray(JCamera.create().rotate(12.0, -5.0, 3.0).rotation)
    want = np.asarray(JCamera.create(rotation=start).rotate(*angles).rotation)
    got = Camera.create(rotation=start, device="cpu").rotate(*angles).rotation
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)  # bit for bit, so within 1e-7


def test_camera_basis_is_columns():
    m = np.arange(9, dtype=np.float32).reshape(3, 3)
    x, y, z = Camera.create(rotation=m, device="cpu").basis()
    assert [float(v) for v in x] == [0.0, 3.0, 6.0]
    assert [float(v) for v in z] == [2.0, 5.0, 8.0]


@pytest.mark.parametrize("n", [16, 32])
def test_hg_lut(n):
    got = henyey_greenstein_lut(n, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n, n, n)
    # XLA's and torch's float32 sin/cos differ by an ulp or two, and
    # 1 + g^2 - 2 g cos(theta) cancels near cos(theta) = 1 (40x at g = 0.8,
    # then the power 3/2): measured max relative difference 1.27e-5 at
    # n = 16 and 32. Both lie within 7.7e-6 of a float64 evaluation.
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_hg(n)), rtol=3e-5, atol=1e-6)
    idx = (np.arange(n, dtype=np.float32) * (np.float32(np.pi) / np.float32(n))).astype(np.float64)
    gam, alp, bet = idx[:, None, None], idx[None, :, None], idx[None, None, :]
    cos_t = np.sin(alp) * np.sin(bet) + np.cos(gam) * np.cos(alp) * np.cos(bet)
    exact = 1 / (4 * np.pi) * (1 - 0.64) / np.sqrt((1 + 0.64 - 1.6 * cos_t) ** 3)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=0)


def test_hg_lut_rejects_bad_g():
    with pytest.raises(ValueError):
        henyey_greenstein_lut(8, g=1.5, device="cpu")


@pytest.mark.parametrize("shape", [(16, 16, 16), (9, 20, 13)])
def test_gradient_volumes_exact(shape):
    data = np.random.default_rng(1).random(shape).astype(np.float32)
    got = Volume.create(data, device="cpu").gradient_volumes()
    want = JVolume.create(data).gradient_volumes()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
    got_m = Volume.create(data, device="cpu").grad_matlab()
    want_m = JVolume.create(data).grad_matlab()
    for g, w in zip(got_m, want_m):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


def test_volume_ops():
    data = np.random.default_rng(2).random((6, 5, 4)).astype(np.float32) * 3 - 1
    v = Volume.create(data, element_size_um=(1, 2, 3), device="cpu")
    jv = JVolume.create(data, element_size_um=(1, 2, 3))
    assert v.extent_xyz == jv.extent_xyz == (4, 5, 6)
    assert v.element_size_um == (1.0, 2.0, 3.0)
    np.testing.assert_array_equal(v.pad(2, 0.5).data.numpy(), np.asarray(jv.pad(2, 0.5).data))
    np.testing.assert_array_equal(v.mip().numpy(), np.asarray(jv.mip()))
    np.testing.assert_allclose(v.normalize(0.0, 2.0).data.numpy(),
                               np.asarray(jv.normalize(0.0, 2.0).data), rtol=1e-6, atol=1e-7)
    assert Volume.create(data[0], device="cpu").data.shape == (1, 5, 4)
    with pytest.raises(ValueError):
        Volume.create(np.zeros((2, 2, 2, 2)), device="cpu")


def test_pack_lights_and_settings():
    lights = [([5, 8, -4], [1.0, 0.7, 0.4]), ([1, 2, 3], [0.1, 0.2, 0.3])]
    pos, col = pack_lights([LightSource(*l) for l in lights], device="cpu")
    jpos, jcol = jax_pack_lights([JLight(*l) for l in lights])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    empty_pos, _ = pack_lights([], device="cpu")
    assert empty_pos.shape == (0, 3)
    with pytest.raises(ValueError):
        LightSource([1, 2], [1, 1, 1])
    s = RenderSettings.create(color=(1.0, 0.5, 0.25), device="cpu")
    assert s.color.dtype == torch.float32 and s.color.tolist() == [1.0, 0.5, 0.25]
    assert float(s.opacity_threshold) == float(jnp.float32(0.95))
