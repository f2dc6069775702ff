"""Where the two packages' lit replays part on the smooth flagship shell.

On the noiseless shell (12^3, 16 x 16, lit, one light, the bricked
rehearsal's loss: emission x 1.2 + 0.05 against the scene's own render) the
port's ``replay_backward`` and ``jax.vjp`` of the JAX package's
``render_fused`` part by 2.1e-2 of the emission gradient's scale. These
tests show that the cause is the conditioning of the problem, not a fault
of either package:

- the parting is confined to the voxels within two of the shell's centre,
  where the six emission taps' central differences cancel by symmetry, so
  the normal ``-grad / |grad|`` turns on the last bits of the taps; beyond
  them the packages agree to 1.3e-5 of scale;
- there, float64 central differences of an independent forward
  (``tests/numpy_ref.py`` run in float64) do not settle as the step
  shrinks: they spread further than the packages part, while at the
  largest gradients they agree with both;
- one ulp of noise on the input moves the port's own gradient at the
  centre by as much as the packages part.

The angle adjoint's two conventions give the same gradient here: no normal
comes within 1e-3 rad of the view or the light direction. Gradient cells
therefore carry 5 % seeded noise (``chip_smoke.py``,
``multihost.BrickDemo(noise=0.05)``), which takes the symmetry away.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from volume_renderer_tpu.models.camera import Camera as JCamera
from volume_renderer_tpu.models.scene import RenderSettings as JSettings
from volume_renderer_tpu.models.scene import Scene as JScene
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene

import numpy_ref
from volume_renderer_tpu_torch.ops.forward import render_rows
from volume_renderer_tpu_torch.ops.vjp import replay_backward
from volume_renderer_tpu_torch.utils.flagship import flagship_scene

torch.set_num_threads(1)

VOL, W, H = 12, 16, 16
CENTRE_RADIUS = 2.0   # voxels from the shell's centre where the packages part


@functools.lru_cache(maxsize=None)
def problem():
    """(start scene, options, cotangent, target): the rehearsal's first step."""
    scene = flagship_scene(VOL, lighting=True, device="cpu")
    opts = scene.options(W, H)
    target = render_rows(scene, opts, 0.0, 0, H)
    start = scene.replace(emission=scene.emission.replace(data=scene.emission.data * 1.2 + 0.05))
    image = render_rows(start, opts, 0.0, 0, H)
    return start, opts, 2.0 * (image - target), image, target


def port_grad(scene, opts, g, image, angle_floor):
    return replay_backward(scene, opts, g, image, angle_floor=angle_floor)["emission"].numpy()


@functools.lru_cache(maxsize=None)
def gradients():
    """The emission gradient: the port's in both angle conventions, JAX's."""
    start, opts, g, image, _ = problem()
    s = start.settings
    jscene = JScene(
        emission=JVolume.create(start.emission.data.numpy()),
        absorption=JVolume.create(start.absorption.data.numpy()),
        reflection=JVolume.create(start.reflection.data.numpy()),
        illumination=jnp.asarray(start.illumination.numpy()),
        light_positions=jnp.asarray(start.light_positions.numpy()),
        light_colors=jnp.asarray(start.light_colors.numpy()),
        camera=JCamera.create(rotation=start.camera.rotation.numpy(), focal_length=3.0,
                              distance_to_object=6.0),
        settings=JSettings.create(
            factor_emission=float(s.factor_emission), factor_reflection=float(s.factor_reflection),
            factor_absorption=float(s.factor_absorption), color=tuple(s.color.tolist()),
            opacity_threshold=float(s.opacity_threshold)))
    diff, template = jax_split_scene(jscene)
    jimg, vjp_fn = jax.vjp(
        lambda d: jax_render_fused(jax_merge_scene(template, d), jscene.options(W, H)), diff)
    np.testing.assert_allclose(np.asarray(jimg), image.numpy(), atol=1e-6)
    jax_g = np.asarray(vjp_fn(jnp.asarray(g.numpy()))[0]["emission"])
    return ({floor: port_grad(start, opts, g, image, floor) for floor in (True, False)}, jax_g)


def centre_distance() -> np.ndarray:
    z, y, x = np.mgrid[0:VOL, 0:VOL, 0:VOL]
    c = (VOL - 1) / 2.0
    return np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)


def loss64(emission: np.ndarray) -> float:
    """sum(g * image) of the float64 forward of tests/numpy_ref.py: its F set
    to float64 for the call alone."""
    start, opts, g, _, _ = problem()
    s = start.settings
    saved, numpy_ref.F = numpy_ref.F, np.float64
    try:
        out = numpy_ref.render_numpy(
            emission, start.absorption.data.numpy().astype(np.float64),
            start.reflection.data.numpy().astype(np.float64),
            start.camera.rotation.numpy().astype(np.float64), 3.0, 6.0, 0.0, (1, 1, 1), W, H,
            factor_emission=float(s.factor_emission), factor_reflection=float(s.factor_reflection),
            factor_absorption=float(s.factor_absorption), color=tuple(s.color.tolist()),
            opacity_threshold=float(s.opacity_threshold),
            lut=start.illumination.numpy().astype(np.float64),
            light_positions=start.light_positions.numpy().astype(np.float64),
            light_colors=start.light_colors.numpy().astype(np.float64))
    finally:
        numpy_ref.F = saved
    return float((out * g.numpy().astype(np.float64)).sum())


def central_difference(voxel, h: float) -> float:
    em = problem()[0].emission.data.numpy().astype(np.float64)
    plus, minus = em.copy(), em.copy()
    plus[voxel] += h
    minus[voxel] -= h
    return (loss64(plus) - loss64(minus)) / (2.0 * h)


def test_the_packages_part_only_at_the_shells_centre():
    port, jax_g = gradients()
    scale = float(np.abs(jax_g).max())
    np.testing.assert_array_equal(port[True], port[False])  # no normal near a pole
    part = np.abs(port[True] - jax_g) / scale
    near = centre_distance() <= CENTRE_RADIUS
    # measured 2.10e-2 at voxel (6, 6, 6), nine voxels beyond 1e-3, all near the centre
    assert 1e-2 < part.max() < 5e-2
    assert near[np.unravel_index(part.argmax(), part.shape)]
    assert near[part > 1e-3].all()
    assert part[~near].max() < 5e-5  # measured 1.28e-5


def test_float64_differences_do_not_settle_where_the_packages_part():
    port, jax_g = gradients()
    scale = float(np.abs(jax_g).max())
    part = np.abs(port[True] - jax_g)
    worst = np.unravel_index(part.argmax(), part.shape)
    # measured 2.27e-4, 9.98e-4, 8.68e-3 against a part of 8.9e-4 (both
    # packages as far from any of them as from each other)
    steps = [central_difference(worst, h) for h in (1e-3, 1e-4, 1e-5)]
    assert max(steps) - min(steps) > 3.0 * part[worst]
    for value in (port[True][worst], jax_g[worst]):
        assert min(abs(value - s) for s in steps) > 0.5 * part[worst]
    # the largest gradients, far from the centre: all three agree (measured
    # within 2.4e-5 of scale)
    for flat in np.argsort(np.abs(jax_g).ravel())[::-1][:2]:
        voxel = np.unravel_index(flat, jax_g.shape)
        fd = central_difference(voxel, 1e-5)
        assert abs(port[True][voxel] - fd) < 1e-3 * scale
        assert abs(jax_g[voxel] - fd) < 1e-3 * scale


def test_one_ulp_of_input_noise_moves_the_centre_gradient_as_far():
    port, jax_g = gradients()
    scale = float(np.abs(jax_g).max())
    start, opts, _, _, target = problem()
    sign = np.random.default_rng(0).choice([-1.0, 1.0], size=(VOL,) * 3)
    factor = torch.from_numpy((1.0 + 2.0 ** -23 * sign).astype(np.float32))
    nudged = start.replace(emission=start.emission.replace(data=start.emission.data * factor))
    image = render_rows(nudged, opts, 0.0, 0, H)
    moved = np.abs(port_grad(nudged, opts, 2.0 * (image - target), image, True) - port[True])
    moved /= scale
    near = centre_distance() <= CENTRE_RADIUS
    part = np.abs(port[True] - jax_g) / scale
    # measured 6.0e-2 near the centre (the packages part by 2.1e-2), 2.6e-4 beyond
    assert moved[near].max() > part.max()
    assert moved[centre_distance() > 2.5].max() < 1e-3
