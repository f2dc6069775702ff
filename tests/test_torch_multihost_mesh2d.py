"""The rows x bricks mesh across ranks (``parallel/multihost.py``:
``global_mesh_2d``, ``RankMesh``) on the CPU.

``run_demo(4, device="cpu", bricks=SPEC, bands=2)`` spawns a 2 x 2 world
over gloo: rank k is (band, brick) = divmod(k, 2), and rank (r, b) builds
only the z-rows of brick b of the flagship shell's unlit, lit and
lit-lookup cases (12^3, 16 x 16, 5 % seeded noise) and marches them over band r's 8 image
rows; a second world is 2 x 1 (two ranks, each the whole volume over its
band). Each rank renders (the bands joined over the brick's ranks), keeps
its brick's entry record for its band, calls ``voxel_grads_bricked_ranks``
for the cotangent of the sum-of-squares loss, takes one Adam step of
``train_step_fast_bricked_ranks`` and one of ``render_fused_bricked_ranks``
(the lookup case through the lookup gradient segment). ``run_demo`` itself checks that every
rank holds the same images, losses and replicated values, and the ranks of
one brick the same grid parts, bit for bit.

Here every rank's image is the one-process plain rows x bricks render
(``render_forward_bricked(mesh=make_mesh_2d(R, B, "cpu"))``) bit for bit:
a band's rays and sums are the same. The gradients, summed over the bands,
are held within 1e-5 of scale of the one-process ``render_fused_bricked``
on the same 2-D mesh, and the kernel step against the one-process
``train_step_fast_bricked`` on ``make_mesh(B)`` (the whole image; the loss
within 1e-6 relative). Against the JAX package (8 virtual CPU devices):
the images within ``tests/test_torch_dp.py``'s tolerance of its
``render_forward_bricked(ray_axis="rays")`` on a 2 x 2 mesh; the
parameters' gradients within 1e-4 of scale of its 2-D
``render_fused_bricked``, and the grids of its single-device
``render_fused``: its 2-D backward returns one band's grid gradients
(ROADMAP section 3), so they are never the reference.
"""

from __future__ import annotations

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from volume_renderer_tpu.models.camera import Camera as JCamera
from volume_renderer_tpu.models.scene import RenderSettings as JSettings
from volume_renderer_tpu.models.scene import Scene as JScene
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene
from volume_renderer_tpu.parallel.bricks import render_forward_bricked as jax_bricked
from volume_renderer_tpu.parallel.bricks import render_fused_bricked as jax_fused_bricked

from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.ops import cuda_bricks
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.vjp import GRID_KEYS, merge_scene, split_scene
from volume_renderer_tpu_torch.parallel import bricks, multihost
from volume_renderer_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

torch.set_num_threads(1)

# the flagship shell at 12^3, 16 x 16, with the 5 % seeded noise of every
# gradient cell of chip_smoke.py: on the smooth shell the normal turns on the
# last bits of the taps near its centre, and the two packages' single-device
# lit replays part by 2e-2 of the emission gradient's scale there (1.9e-5
# with the noise; tests/test_torch_smooth_shell.py)
SPEC = multihost.BrickDemo(noise=0.05)
WORLDS = {"2x2": (2, 2), "2x1": (2, 1)}  # (bands, bricks)
STEPPED = multihost.BRICK_CASES
RANK_GRAD_TOL = 1e-5   # of scale: the bands' sums and the scatter's in another order
LOSS_TOL = 1e-6        # relative: the loss summed over the bands
TOL_JAX = 1e-4         # of scale, against the JAX package's gradients


@pytest.fixture(scope="module")
def demo_2x2():
    return multihost.run_demo(4, device="cpu", timeout=240.0, bricks=SPEC, bands=2)


@pytest.fixture(scope="module")
def demo_2x1():
    return multihost.run_demo(2, device="cpu", timeout=240.0, bricks=SPEC, bands=2)


@pytest.fixture(params=list(WORLDS))
def world(request):
    """(bands, bricks, each rank's results) of a world."""
    return (*WORLDS[request.param], request.getfixturevalue(f"demo_{request.param}"))


@functools.lru_cache(maxsize=None)
def cases():
    return multihost.brick_demo_cases("cpu", SPEC)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def joined(demo, n_bricks, case, step, part, key):
    """A grid key of band 0's ranks, joined in brick order (every band's
    ranks hold the same parts: ``run_demo`` checked it); a replicated key as
    rank 0 holds it."""
    if key in GRID_KEYS:
        return bricks.assemble([r[case][step][part][key] for r in demo[:n_bricks]]).numpy()
    return np.asarray(demo[0][case][step][part][key])


def check(got: dict, want: dict, what: str, tol: float = RANK_GRAD_TOL):
    for key, value in want.items():
        value = bricks.assemble(value) if isinstance(value, list) else value
        err = rel_err(got[key], value.detach().numpy())
        assert err <= tol, f"{what} {key}: {err:.3e} of scale"


def step_cotangent(case):
    """The cotangent of the steps' loss from the demo's start: the ranks'
    image of the start params is the one-process plain 2-D image, to the bit."""
    scene, opts, target, start = cases()[case]
    image = bricks.render_forward_bricked(train.merge_params(start, scene), opts,
                                          mesh=make_mesh_2d(2, 2, "cpu"))
    return 2.0 * (image - target)


@functools.lru_cache(maxsize=None)
def fused_2d(case, n_bands, n_bricks):
    """(loss, grads, params after one Adam step) of the one-process
    ``render_fused_bricked`` on the same rows x bricks mesh, from the
    demo's start."""
    scene, opts, target, start = cases()[case]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=multihost.DEMO["lr"])
    img = bricks.render_fused_bricked(train.merge_params(params, scene), opts,
                                      mesh=make_mesh_2d(n_bands, n_bricks, "cpu"))
    loss = torch.sum((img - target) ** 2)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in params.items()}
    optimizer.step()
    return float(loss.detach()), grads, params


@pytest.mark.parametrize("case", multihost.BRICK_CASES)
def test_ranks_render_the_one_process_2d_image_and_records(world, case):
    n_bands, n_bricks, demo = world
    scene, opts, _, _ = cases()[case]
    want = bricks.render_forward_bricked(scene, opts, mesh=make_mesh_2d(n_bands, n_bricks, "cpu"))
    split = bricks.split_bricks(scene, make_mesh(n_bricks, "cpu"))
    rows = opts.height // n_bands
    assert [r["rank"] for r in demo] == list(range(n_bands * n_bricks))
    for r in demo:
        assert (r["band"], r["brick"]) == divmod(r["rank"], n_bricks) and r["bands"] == n_bands
        assert r[case]["launches"] == {}  # on the CPU no kernel launch is counted
        assert set(r[case]["rows"].values()) == {SPEC.volume // n_bricks}
        torch.testing.assert_close(r[case]["image"], want, rtol=0, atol=0)
        _, entry = cuda_bricks.brick_transmittance(split.bricks[r["brick"]], opts,
                                                   y_offset=r["band"] * rows, n_rows=rows)
        torch.testing.assert_close(r[case]["entry"]["step"], entry.step, rtol=0, atol=0)
        torch.testing.assert_close(r[case]["entry"]["state"], entry.state, rtol=0, atol=0)
    assert float(want.max()) > 0.0


@pytest.mark.parametrize("case", STEPPED)
def test_rank_gradients_are_the_one_process_2d_gradients(world, case):
    """``voxel_grads_bricked_ranks``: grids the rank's part, parameters and
    grids summed over the bands, against ``render_fused_bricked`` on the
    same 2-D mesh for the same cotangent."""
    n_bands, n_bricks, demo = world
    scene, opts, target, _ = cases()[case]
    g = 2.0 * (demo[0][case]["image"] - target)
    diff, template = split_scene(scene)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in diff.items()}
    img = bricks.render_fused_bricked(merge_scene(template, leaves), opts,
                                      mesh=make_mesh_2d(n_bands, n_bricks, "cpu"))
    img.backward(g)
    got = demo[0][case]["grads"]["grads"]
    assert set(got) == set(leaves) | {"reflection", "factor_reflection"} | (
        {"light_colors"} if case != "unlit" else set())
    for r in demo:
        for key in GRID_KEYS:
            if key in got:
                assert tuple(r[case]["grads"]["grads"][key].shape) == (
                    SPEC.volume // n_bricks, SPEC.volume, SPEC.volume)
    check({k: joined(demo, n_bricks, case, "grads", "grads", k) for k in leaves},
          {k: v.grad for k, v in leaves.items()}, case)


@pytest.mark.parametrize("case", multihost.BRICK_CASES)
def test_fused_rank_step_is_the_one_process_2d_step(world, case):
    """``render_fused_bricked_ranks`` on the 2-D mesh through autograd (grid
    leaves whole: summed over the bands, then gathered over the band)
    against ``render_fused_bricked`` on the same mesh; the lookup scene too."""
    n_bands, n_bricks, demo = world
    loss, grads, params = fused_2d(case, n_bands, n_bricks)
    got = demo[0][case]["fused"]
    assert abs(got["loss"] - loss) <= LOSS_TOL * loss
    check({k: joined(demo, n_bricks, case, "fused", "grads", k) for k in grads}, grads, case)
    check({k: joined(demo, n_bricks, case, "fused", "params", k) for k in params}, params, case)


@pytest.mark.parametrize("case", STEPPED)
def test_rank_step_is_the_one_process_step(world, case):
    """The kernel step over the bands against one process's
    ``train_step_fast_bricked`` on ``make_mesh(B)`` over the whole image:
    the loss summed over the bands, every gradient too."""
    n_bands, n_bricks, demo = world
    scene, opts, target, start = cases()[case]
    params, static = bricks.split_params_bricked(train.merge_params(start, scene),
                                                 make_mesh(n_bricks, "cpu"))
    optimizer = torch.optim.Adam(bricks.param_leaves(params), lr=multihost.DEMO["lr"])
    loss = float(bricks.train_step_fast_bricked(params, optimizer, static, opts, target))
    got = demo[0][case]["fast"]
    assert abs(got["loss"] - loss) <= LOSS_TOL * loss
    grads = {k: [p.grad for p in v] if isinstance(v, list) else v.grad for k, v in params.items()}
    check({k: joined(demo, n_bricks, case, "fast", "grads", k) for k in params}, grads, case)
    check({k: joined(demo, n_bricks, case, "fast", "params", k) for k in params}, params, case)
    for r in demo:
        for key in ("emission", "absorption"):
            assert r[case]["fast"]["params"][key].shape[0] == SPEC.volume // n_bricks


def test_a_bricks_parts_are_equal_across_its_bands(world):
    n_bands, n_bricks, demo = world
    for b in range(n_bricks):
        ranks = demo[b::n_bricks]
        assert [r["brick"] for r in ranks] == [b] * n_bands
        for case in STEPPED:
            for step, part in (("grads", "grads"), ("fast", "grads"), ("fast", "params"),
                               ("fused", "grads"), ("fused", "params")):
                for key in ("emission", "absorption"):
                    for other in ranks[1:]:
                        torch.testing.assert_close(other[case][step][part][key],
                                                   ranks[0][case][step][part][key],
                                                   rtol=0, atol=0)


def test_lookup_gradients_raise_on_every_rank(world):
    """The lookup case's kernel gradients (refused before the lookup
    gradient segment) on every rank of the world: the three gradient
    volumes' parts among them, summed over the bands, within 1e-5 of scale
    of the single-device plain replay for the same cotangent."""
    n_bands, n_bricks, demo = world
    scene, opts, target, _ = cases()["lookup"]
    g = 2.0 * (demo[0]["lookup"]["image"] - target)
    _, want = voxel_grads_fast(scene, opts, g)
    assert {"gradient_x", "gradient_y", "gradient_z"} <= set(want)
    for r in demo:
        assert {"fast", "fused"} <= set(r["lookup"])
        assert set(r["lookup"]["grads"]["grads"]) == set(want)
    check({k: joined(demo, n_bricks, "lookup", "grads", "grads", k) for k in want}, want,
          "lookup")


# ---- against the JAX package -----------------------------------------------


def jax_scene(case):
    """The JAX package's scene of a demo case, from the port's arrays."""
    scene, _, _, _ = cases()[case]
    s = scene.settings

    def vol(v):
        return None if v is None else JVolume.create(v.data.numpy())

    def arr(t):
        return None if t is None else jnp.asarray(t.numpy())

    return JScene(
        emission=vol(scene.emission), absorption=vol(scene.absorption),
        reflection=vol(scene.reflection), gradient_x=vol(scene.gradient_x),
        gradient_y=vol(scene.gradient_y), gradient_z=vol(scene.gradient_z),
        illumination=arr(scene.illumination), light_positions=arr(scene.light_positions),
        light_colors=arr(scene.light_colors),
        camera=JCamera.create(rotation=scene.camera.rotation.numpy(),
                              focal_length=scene.camera.focal_length,
                              distance_to_object=scene.camera.distance_to_object),
        settings=JSettings.create(
            factor_emission=float(s.factor_emission), factor_reflection=float(s.factor_reflection),
            factor_absorption=float(s.factor_absorption), color=tuple(s.color.tolist()),
            opacity_threshold=float(s.opacity_threshold)))


def jax_mesh_2d():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("rays", "bricks"))


@pytest.mark.parametrize("case", multihost.BRICK_CASES)
def test_images_match_the_jax_rows_x_bricks_render(demo_2x2, case):
    jscene = jax_scene(case)
    jimg = jax_bricked(jscene, jscene.options(SPEC.width, SPEC.height), mesh=jax_mesh_2d(),
                       ray_axis="rays")
    for r in demo_2x2:
        np.testing.assert_allclose(r[case]["image"].numpy(), np.asarray(jimg),
                                   atol=5e-6, rtol=5e-5)


@pytest.mark.parametrize("case", STEPPED)
def test_step_gradients_match_the_jax_package(demo_2x2, case):
    """The fused and the kernel step's gradients, for the steps' cotangent:
    the parameters against ``jax.vjp`` of the JAX 2-D ``render_fused_bricked``,
    every key against its single-device ``render_fused``."""
    scene, opts, _, start = cases()[case]
    g = jnp.asarray(step_cotangent(case).numpy())
    jstart = jax_scene(case)
    jstart = jstart.replace(emission=jstart.emission.replace(
        data=jnp.asarray(start["emission"].detach().numpy())))
    jopts = jstart.options(SPEC.width, SPEC.height)
    diff, template = jax_split_scene(jstart)
    want = {}
    renders = {"single": lambda s: jax_render_fused(s, jopts)}
    if case != "lookup":  # the JAX 2-D backward of a lit lookup scene is not held against
        renders["2d"] = lambda s: jax_fused_bricked(s, jopts, mesh=jax_mesh_2d(), ray_axis="rays")
    for name, render in renders.items():
        _, vjp_fn = jax.vjp(lambda d: render(jax_merge_scene(template, d)), diff)
        want[name] = {k: np.asarray(v) for k, v in vjp_fn(g)[0].items()}
    for step in ("fused", "fast"):
        got = {k: joined(demo_2x2, 2, case, step, "grads", k)
               for k in demo_2x2[0][case][step]["grads"]}
        for key, value in got.items():
            err = rel_err(value, want["single"][key])
            assert err <= TOL_JAX, f"{step} {key}: {err:.3e} of the single-device scale"
            if key not in GRID_KEYS and "2d" in want:
                err = rel_err(value, want["2d"][key])
                assert err <= TOL_JAX, f"{step} {key}: {err:.3e} of the 2-D scale"


# ---- refusals ----------------------------------------------------------------


@pytest.fixture
def one_rank():
    """A process group of one rank on the CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize("file://" + os.path.join(tmp, "store"), 1, 0, device="cpu")
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_a_mesh_must_cover_the_group_and_its_band_the_image(one_rank):
    scene, opts, _, _ = cases()["unlit"]
    for n_bands, n_bricks in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="does not cover the group's 1 ranks"):
            multihost.global_mesh_2d(n_bands, n_bricks)
    mesh = multihost.global_mesh_2d(1, 1)
    assert (mesh.n_bands, mesh.n_bricks, mesh.band, mesh.brick) == (1, 1, 0, 0)
    torch.testing.assert_close(
        multihost.render_forward_bricked_ranks(scene, opts, mesh=mesh),
        bricks.render_forward_bricked_fast(scene, opts, mesh=make_mesh(1, "cpu")),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="divisible by the ray axis size 3"):
        multihost.RankMesh(3, 1, 0, 0, None, None).rows(opts)
    assert multihost.RankMesh(2, 1, 1, 0, None, None).rows(opts) == (8, 8)
    with pytest.raises(ValueError, match="are not rank 0's"):
        multihost.render_forward_bricked_ranks(scene, opts,
                                               mesh=multihost.RankMesh(1, 1, 0, 1, None, None))


def test_run_demo_refuses_a_world_that_is_not_bands_x_bricks(monkeypatch):
    monkeypatch.setattr(torch.multiprocessing, "get_context",
                        lambda *a: pytest.fail("spawned ranks"))
    with pytest.raises(ValueError, match="multiple of 2 processes, not 3"):
        multihost.run_demo(3, device="cpu", bricks=SPEC, bands=2)
    with pytest.raises(ValueError, match="divisible by the ray axis size 3"):
        multihost.run_demo(3, device="cpu", bricks=SPEC, bands=3)
    with pytest.raises(ValueError, match="bricked rehearsal"):
        multihost.run_demo(2, device="cpu", bands=2)


def test_one_process_fast_entry_points_still_refuse_a_2d_mesh():
    scene, opts, target, start = cases()["unlit"]
    mesh = make_mesh_2d(2, 2, "cpu")
    with pytest.raises(ValueError, match="no ray axis"):
        bricks.render_forward_bricked_fast(scene, opts, mesh=mesh)
    with pytest.raises(ValueError, match="no ray axis"):
        bricks.voxel_grads_bricked_fast(scene, opts, torch.zeros_like(target), mesh=mesh)
    params, static = train.split_params(scene)
    optimizer = torch.optim.Adam(list(params.values()), lr=1e-3)
    with pytest.raises(ValueError, match="no ray axis"):
        bricks.train_step_fast_bricked(params, optimizer, static, opts, target, mesh=mesh)
    with pytest.raises(ValueError, match="no ray axis"):
        bricks.split_params_bricked(scene, mesh)
