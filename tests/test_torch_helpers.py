"""Fixtures shared by the PyTorch port's tests, and their own checks.

``make_scenes`` builds one scene from numpy inputs made from a seed, twice:
as a JAX ``Scene`` and, through ``scene_from_arrays``, as a port ``Scene``
on the CPU. The port never sees a JAX object: ``arrays_of`` hands the JAX
scene's leaves across as numpy.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volume_renderer_tpu.models.camera import Camera as JCamera
from volume_renderer_tpu.models.scene import RenderSettings as JSettings
from volume_renderer_tpu.models.scene import Scene as JScene
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.ops.hg import henyey_greenstein_lut as jax_hg

from volume_renderer_tpu_torch.convert import scene_from_arrays

torch.set_num_threads(1)

LIGHT_POS = np.array([[2.0, 3.0, -1.5], [-1.0, 2.0, 2.0]], np.float32)
LIGHT_COL = np.array([[1.0, 0.5, 1.0], [0.0, 1.0, 1.0]], np.float32)


def smooth_volume(rng, shape, scale=1.0):
    """Nonnegative smooth volume: a few random gaussian blobs."""
    d, h, w = shape
    z, y, x = np.mgrid[0:d, 0:h, 0:w].astype(np.float32)
    out = np.zeros(shape, np.float32)
    for _ in range(4):
        c = rng.random(3) * np.array([d, h, w])
        s = (0.2 + 0.3 * rng.random()) * min(shape)
        r2 = ((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) / (s * s)
        out += (rng.random() * np.exp(-r2)).astype(np.float32)
    return (out * scale).astype(np.float32)


def arrays_of(scene) -> dict:
    """The leaves of a JAX ``Scene`` as numpy, keyed for ``scene_from_arrays``."""
    def vol(v):
        return None if v is None else np.asarray(v.data)

    def arr(a):
        return None if a is None else np.asarray(a)

    s = scene.settings
    return dict(
        emission=vol(scene.emission), absorption=vol(scene.absorption),
        reflection=vol(scene.reflection), gradient_x=vol(scene.gradient_x),
        gradient_y=vol(scene.gradient_y), gradient_z=vol(scene.gradient_z),
        illumination=arr(scene.illumination), light_positions=arr(scene.light_positions),
        light_colors=arr(scene.light_colors),
        rotation=np.asarray(scene.camera.rotation),
        focal_length=float(scene.camera.focal_length),
        distance_to_object=float(scene.camera.distance_to_object),
        factor_emission=np.asarray(s.factor_emission),
        factor_reflection=np.asarray(s.factor_reflection),
        factor_absorption=np.asarray(s.factor_absorption),
        color=np.asarray(s.color), opacity_threshold=np.asarray(s.opacity_threshold),
        element_size_um=scene.emission.element_size_um,
    )


def make_scenes(seed=0, vol_shape=(20, 16, 24), element_size_um=(1.0, 1.0, 1.0),
                lighting=False, gradient_volumes=False, alias_absorption=False,
                alias_reflection=False, n_lights=1, lut_size=16, rotate=(30.0, -20.0, 10.0),
                factors=(1.0, 0.4, 0.6), color=(1.0, 0.9, 0.8), opacity_threshold=0.95):
    """(JAX scene, port scene on the CPU) of one seeded scene."""
    rng = np.random.default_rng(seed)
    em = smooth_volume(rng, vol_shape, 2.0)
    ab = smooth_volume(rng, vol_shape, 1.5)
    re = smooth_volume(rng, vol_shape, 1.0)
    cam = JCamera.create(focal_length=3.0, distance_to_object=6.0).rotate(*rotate)
    kwargs = {}
    if lighting:
        kwargs.update(illumination=jax_hg(lut_size),
                      light_positions=jnp.asarray(LIGHT_POS[:n_lights]),
                      light_colors=jnp.asarray(LIGHT_COL[:n_lights]))
        if gradient_volumes:
            gx, gy, gz = JVolume.create(em).gradient_volumes()
            kwargs.update(gradient_x=gx, gradient_y=gy, gradient_z=gz)
    scene = JScene(
        emission=JVolume.create(em, element_size_um),
        absorption=None if alias_absorption else JVolume.create(ab, element_size_um),
        reflection=None if alias_reflection else JVolume.create(re, element_size_um),
        camera=cam,
        settings=JSettings.create(factor_emission=factors[0], factor_reflection=factors[1],
                                  factor_absorption=factors[2], color=color,
                                  opacity_threshold=opacity_threshold),
        **kwargs,
    )
    return scene, scene_from_arrays(arrays_of(scene), device="cpu")


@pytest.mark.parametrize("lighting,gradient_volumes", [(False, False), (True, False),
                                                       (True, True)])
def test_scene_from_arrays_carries_every_leaf(lighting, gradient_volumes):
    jscene, tscene = make_scenes(lighting=lighting, gradient_volumes=gradient_volumes,
                                 element_size_um=(1.0, 1.5, 2.0))
    arrays = arrays_of(jscene)
    assert tscene.device == torch.device("cpu")
    assert tscene.emission.element_size_um == (1.0, 1.5, 2.0)
    assert tscene.has_lighting == lighting
    assert tscene.has_gradient_volumes == gradient_volumes
    for key in ("emission", "absorption", "reflection", "gradient_x"):
        got = getattr(tscene, key)
        if arrays[key] is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.data.numpy(), arrays[key])
    np.testing.assert_array_equal(tscene.camera.rotation.numpy(), arrays["rotation"])
    np.testing.assert_array_equal(tscene.settings.color.numpy(), arrays["color"])
    assert float(tscene.settings.factor_absorption) == float(arrays["factor_absorption"])
    assert tscene.camera.focal_length == 3.0


def test_scene_from_arrays_rejects_unknown_keys():
    with pytest.raises(KeyError):
        scene_from_arrays({"emission": np.ones((2, 2, 2), np.float32), "emision": 1.0},
                          device="cpu")
