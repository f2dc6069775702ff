"""The port's rays, box clip and trilinear sampling against the JAX
package's, at random inputs made with numpy from a seed."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.models.camera import Camera as JCamera
from volume_renderer_tpu.ops.float3 import F3 as JF3
from volume_renderer_tpu.ops.geometry import generate_rays as jax_rays
from volume_renderer_tpu.ops.geometry import intersect_box as jax_box
from volume_renderer_tpu.ops.sampling import sample_trilinear as jax_sample
from volume_renderer_tpu.ops.sampling import trilinear_setup as jax_setup

from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.ops.float3 import F3, dot, length, normalize, where3
from volume_renderer_tpu_torch.ops.geometry import generate_rays, intersect_box
from volume_renderer_tpu_torch.ops.sampling import sample_trilinear, trilinear_setup

torch.set_num_threads(1)

W, H = 64, 48


def _t3(a):
    return F3(*(torch.as_tensor(np.asarray(c, np.float32)) for c in a))


def _j3(a):
    return JF3(*(jnp.asarray(np.asarray(c, np.float32)) for c in a))


def _rays(angles, cam_off):
    jcam = JCamera.create(focal_length=3.0, distance_to_object=6.0).rotate(*angles)
    cam = Camera.create(rotation=np.asarray(jcam.rotation), focal_length=3.0,
                        distance_to_object=6.0, device="cpu")
    r = np.arange(W * H, dtype=np.int32)
    px, py = r % W, r // W
    jo, jd = jax_rays(W, H, *jcam.basis(), jnp.float32(cam_off), jnp.float32(3.0),
                      jnp.float32(6.0), jnp.asarray(px), jnp.asarray(py))
    to, td = generate_rays(W, H, *cam.basis(), cam_off, 3.0, 6.0,
                           torch.as_tensor(px, dtype=torch.int64),
                           torch.as_tensor(py, dtype=torch.int64))
    return (jo, jd), (to, td)


@pytest.mark.parametrize("angles,cam_off", [((125.0, 25.0, 0.0), 0.0),
                                            ((30.0, -20.0, 10.0), 0.125),
                                            ((0.0, 90.0, 0.0), -0.25)])
def test_generate_rays_and_box(angles, cam_off):
    (jo, jd), (to, td) = _rays(angles, cam_off)
    for a, b in zip(to + td, jo + jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    box_min, box_max = (-1.0, -0.75, -0.5), (1.0, 0.75, 0.5)
    jhit, jn, jf = jax_box(jo, jd, _j3(box_min), _j3(box_max))
    thit, tn, tf = intersect_box(to, td, _t3(box_min), _t3(box_max))
    assert 0 < int(thit.sum()) < W * H  # some rays miss, some hit
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    h = thit.numpy()
    np.testing.assert_allclose(tn.numpy()[h], np.asarray(jn)[h], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.numpy()[h], np.asarray(jf)[h], rtol=1e-6, atol=1e-6)


def test_only_x_vec_is_renormalized():
    rot = np.diag([2.0, 3.0, 1.0]).astype(np.float32)  # unnormalized basis
    cam = Camera.create(rotation=rot, device="cpu")
    _, d = generate_rays(4, 4, *cam.basis(), 0.0, 1.0, 1.0, torch.tensor([0]), torch.tensor([0]))
    # u = -1 on the unit x axis; v = -1 on the 3-long y axis; focal 1 on z
    np.testing.assert_allclose([d.x.item(), d.y.item(), d.z.item()],
                               np.array([-1.0, -3.0, 1.0]) / np.sqrt(11.0), rtol=1e-6)


@pytest.mark.parametrize("shape", [(16, 16, 16), (9, 7, 5), (1, 1, 1), (32, 20, 24)])
def test_sample_trilinear(shape):
    rng = np.random.default_rng(sum(shape))
    vol = rng.random(shape).astype(np.float32)
    # out-of-range coordinates exercise the clamp addressing
    coords = rng.uniform(-0.4, 1.4, size=(3, 2000)).astype(np.float32)
    want = np.asarray(jax_sample(jnp.asarray(vol), _j3(coords)))
    got = sample_trilinear(torch.as_tensor(vol), _t3(coords))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ti0, ti1, *tw = trilinear_setup(shape, _t3(coords))
    ji0, ji1, *jw = jax_setup(shape, _j3(coords))
    for a, b in zip(ti0 + ti1, ji0 + ji1):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_far_out_of_range_clamps():
    vol = np.random.default_rng(4).random((5, 6, 7)).astype(np.float32)
    far = sample_trilinear(torch.as_tensor(vol), _t3([[-1e9, 1e9], [-1e9, 1e9], [-1e9, 1e9]]))
    np.testing.assert_array_equal(far.numpy(), [vol[0, 0, 0], vol[-1, -1, -1]])


def test_float3_helpers():
    a = _t3([[3.0, 0.0], [4.0, 0.0], [0.0, 0.0]])
    np.testing.assert_array_equal(length(a).numpy(), [5.0, 0.0])
    n = normalize(a)
    np.testing.assert_allclose(n.x.numpy(), [0.6, 0.0], rtol=1e-6)
    assert dot(n, n)[1] == 0.0  # zero-length input -> zero vector
    w = where3(torch.tensor([True, False]), a, -a)
    np.testing.assert_array_equal(w.x.numpy(), [3.0, -0.0])
