"""The z-brick relay across ranks (``parallel/multihost.py``) on the CPU.

``run_demo(4, device="cpu", bricks=SPEC)`` spawns four processes over gloo,
rank r holding brick r of 4 (16^3: bricks of 4 rows, 32 x 32 image). Each
rank builds only its own z-rows of the unlit, lit and lit-lookup flagship
cases (the whole scene only for the fused step, whose grid leaves are
whole), gets the target images from the parent, renders, keeps its brick's
entry record, takes one Adam step of ``train_step_fast_bricked_ranks``,
calls ``voxel_grads_bricked_ranks`` for the step's cotangent (the lookup
case through the lookup gradient segment) and takes one Adam step of
``render_fused_bricked_ranks``. ``run_demo`` itself checks that
every rank holds the same images, losses and replicated values, bit for bit.

Here the ranks' grid parts, joined, and their entry records are held
against the one-process bricked path on ``make_mesh(4, "cpu")`` bit for
bit; the images too (every rank sums the gathered contributions in brick
order, as the one process does); the losses and the parameters' gradients,
which the ranks sum with ``all_reduce``, within 1e-6 of scale. The camera
looks down z (``rotate=(180, 0, 0)``), inside the envelope of the JAX
package's bricked kernels, which the image and the unlit gradients are held
against on a 4-device mesh in interpret mode.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from volume_renderer_tpu.models.camera import Camera as JCamera
from volume_renderer_tpu.models.scene import RenderSettings as JSettings
from volume_renderer_tpu.models.scene import Scene as JScene
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.ops.pallas_march import last_fallback_reason
from volume_renderer_tpu.parallel.bricks import voxel_grads_bricked_fast as jax_grads_fast
from volume_renderer_tpu.parallel.sharding import make_mesh as jax_make_mesh

from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks
from volume_renderer_tpu_torch.ops.brick_march import HALO
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.vjp import GRID_KEYS
from volume_renderer_tpu_torch.parallel import bricks, multihost
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

RANKS = 4
SPEC = multihost.BrickDemo(volume=16, width=32, height=32, rotate=(180.0, 0.0, 0.0))
STEPPED = multihost.BRICK_CASES
TOL_SCALE = 1e-6   # the parameters' gradients: all_reduce sums in its own order
TOL_JAX = 3e-4     # tests/test_torch_bricks_grads.py: the port against the JAX kernel path


@pytest.fixture(scope="module")
def demo():
    return multihost.run_demo(RANKS, device="cpu", timeout=240.0, bricks=SPEC)


@functools.lru_cache(maxsize=None)
def cases():
    return multihost.brick_demo_cases("cpu", SPEC)


def mesh():
    return make_mesh(RANKS, "cpu")


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def joined(demo, case, step, part, key):
    """A grid key of every rank, joined in rank order; a replicated key as
    rank 0 holds it (``run_demo`` checked that every rank holds it so)."""
    if key in GRID_KEYS:
        return bricks.assemble([r[case][step][part][key] for r in demo]).numpy()
    return np.asarray(demo[0][case][step][part][key])


def check_grads(got: dict, want: dict, what: str):
    """Grids bit for bit, the parameters within ``TOL_SCALE`` of scale."""
    for key, value in want.items():
        value = bricks.assemble(value) if isinstance(value, list) else value
        if key in GRID_KEYS:
            np.testing.assert_array_equal(got[key], value.detach().numpy(), err_msg=f"{what} {key}")
        else:
            err = rel_err(got[key], value.detach().numpy())
            assert err <= TOL_SCALE, f"{what} {key}: {err:.3e} of scale"


@functools.lru_cache(maxsize=None)
def single_grads(case):
    """The one-process ``voxel_grads_bricked_fast`` for the ranks' cotangent."""
    scene, opts, target, _ = cases()[case]
    image = bricks.render_forward_bricked_fast(scene, opts, mesh=mesh())
    return bricks.voxel_grads_bricked_fast(scene, opts, 2.0 * (image - target), mesh=mesh())


@pytest.mark.parametrize("case", multihost.BRICK_CASES)
def test_ranks_render_the_one_process_image_and_records(demo, case):
    scene, opts, _, _ = cases()[case]
    want = bricks.render_forward_bricked_fast(scene, opts, mesh=mesh())
    split = bricks.split_bricks(scene, mesh())
    assert [r["rank"] for r in demo] == list(range(RANKS))
    for r in demo:
        assert r["backend"] == "gloo" and r["mesh"] == ["cpu"] * RANKS
        assert r[case]["launches"] == {}  # on the CPU no kernel launch is counted
        np.testing.assert_array_equal(r[case]["image"].numpy(), want.numpy())
        _, entry = cuda_bricks.brick_transmittance(split.bricks[r["rank"]], opts)
        np.testing.assert_array_equal(r[case]["entry"]["step"].numpy(), entry.step.numpy())
        np.testing.assert_array_equal(r[case]["entry"]["state"].numpy(), entry.state.numpy())


@pytest.mark.parametrize("case", STEPPED)
def test_rank_gradients_are_the_one_process_gradients(demo, case):
    """``voxel_grads_bricked_ranks``: the grids this rank's part, the
    parameters summed over the ranks."""
    _, want = single_grads(case)
    assert set(demo[0][case]["grads"]["grads"]) == set(want)
    for r in demo:
        for key, value in r[case]["grads"]["grads"].items():
            if key in GRID_KEYS:
                assert tuple(value.shape) == (SPEC.volume // RANKS, SPEC.volume, SPEC.volume)
    check_grads({k: joined(demo, case, "grads", "grads", k) for k in want}, want, case)


@pytest.mark.parametrize("case", STEPPED)
def test_rank_step_is_the_one_process_step(demo, case):
    scene, opts, target, start = cases()[case]
    params, static = bricks.split_params_bricked(train.merge_params(start, scene), mesh())
    optimizer = torch.optim.Adam(bricks.param_leaves(params), lr=multihost.DEMO["lr"])
    loss = bricks.train_step_fast_bricked(params, optimizer, static, opts, target)
    got = demo[0][case]["fast"]
    assert abs(got["loss"] - float(loss)) <= TOL_SCALE * float(loss)
    grads = {k: [p.grad for p in v] if isinstance(v, list) else v.grad for k, v in params.items()}
    check_grads({k: joined(demo, case, "fast", "grads", k) for k in params}, grads, case)
    check_grads({k: joined(demo, case, "fast", "params", k) for k in params}, params, case)


@pytest.mark.parametrize("case", multihost.BRICK_CASES)
def test_fused_rank_step_is_render_fused_bricked(demo, case):
    """``render_fused_bricked_ranks`` through autograd against
    ``render_fused_bricked`` on one process, from the same start; the
    lookup scene too."""
    scene, opts, target, start = cases()[case]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=multihost.DEMO["lr"])
    img = bricks.render_fused_bricked(train.merge_params(params, scene), opts, mesh=mesh())
    loss = torch.sum((img - target) ** 2)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in params.items()}
    optimizer.step()
    got = demo[0][case]["fused"]
    assert abs(got["loss"] - float(loss.detach())) <= TOL_SCALE * float(loss.detach())
    check_grads({k: joined(demo, case, "fused", "grads", k) for k in params}, grads, case)
    check_grads({k: joined(demo, case, "fused", "params", k) for k in params}, params, case)


def test_lit_lookup_scene_renders_and_its_gradients_raise(demo):
    """The lookup case (whose gradients raised before the lookup gradient
    segment) on every rank: rendered, its gradients with the three gradient
    volumes' parts, its kernel and fused steps; the joined gradients within
    1e-5 of scale of the single-device plain replay (``voxel_grads_fast``)
    for the ranks' cotangent, as the lit case's are."""
    scene, opts, target, _ = cases()["lookup"]
    g = 2.0 * (demo[0]["lookup"]["image"] - target)
    _, want = voxel_grads_fast(scene, opts, g)
    assert {"gradient_x", "gradient_y", "gradient_z"} <= set(want)
    for r in demo:
        assert float(r["lookup"]["image"].max()) > 0.0
        assert {"fast", "fused"} <= set(r["lookup"])
        assert set(r["lookup"]["grads"]["grads"]) == set(want)
    for key, value in want.items():
        err = rel_err(joined(demo, "lookup", "grads", "grads", key), value.numpy())
        assert err <= 1e-5, f"{key}: {err:.3e} of the gradient's scale"


def test_halo_rows_return_to_their_owners(demo):
    """Each brick scatters into its halo-padded grids; the rows it holds as
    halo are its neighbours' and go back to them across ranks. The joined
    rank parts are the one-process ``_return_halo`` of the padded grids,
    and the returned terms are not zero on the rows beside the faces."""
    scene, opts, target, _ = cases()["unlit"]
    split = bricks.split_bricks(scene, mesh())
    fwd = bricks._forward(split, opts, 0.0, fast=True)
    g = 2.0 * (fwd.image - target)
    up = bricks._upstream([brick_march.own_dot(g, own) for own in fwd.own], fwd.ascending,
                          torch.cumsum, 0.0)
    padded = [cuda_bricks.brick_gradients(b, opts, 0.0, g, fwd.image, w, u, e)["emission"]
              for b, w, u, e in zip(split.bricks, fwd.w_in, up, fwd.entry)]
    got = joined(demo, "unlit", "grads", "grads", "emission")
    np.testing.assert_array_equal(got, bricks.assemble(bricks._return_halo(padded)).numpy())
    own_rows = np.concatenate([p[HALO:-HALO].numpy() for p in padded])
    rows = SPEC.volume // RANKS
    face_rows = sorted({r * rows + d for r in range(1, RANKS) for d in range(-HALO, HALO)})
    assert np.abs(got[face_rows] - own_rows[face_rows]).max() > 0.0
    inner = [z for z in range(SPEC.volume) if z not in face_rows]
    np.testing.assert_array_equal(got[inner], own_rows[inner])


def jax_scene(case):
    """The JAX package's scene of a demo case, from the port's arrays."""
    scene, _, _, _ = cases()[case]
    s = scene.settings
    return JScene(
        emission=JVolume.create(scene.emission.data.numpy()),
        absorption=JVolume.create(scene.absorption.data.numpy()),
        reflection=JVolume.create(scene.reflection.data.numpy()),
        camera=JCamera.create(focal_length=3.0, distance_to_object=6.0).rotate(*SPEC.rotate),
        settings=JSettings.create(
            factor_emission=float(s.factor_emission), factor_reflection=float(s.factor_reflection),
            factor_absorption=float(s.factor_absorption), color=tuple(s.color.tolist()),
            opacity_threshold=float(s.opacity_threshold)))


def test_unlit_image_and_grids_match_the_jax_bricked_kernels(demo):
    """The JAX package's ``voxel_grads_bricked_fast`` (its three kernel
    sweeps a brick, Pallas in interpret mode, as tests/test_bricks.py runs
    it) on a 4-device mesh, for the ranks' cotangent: the image at
    ``render_forward_bricked_fast``'s tolerance of tests/test_torch_bricks.py,
    the grids at tests/test_torch_bricks_grads.py's."""
    jscene = jax_scene("unlit")
    np.testing.assert_array_equal(np.asarray(jscene.camera.rotation),
                                  cases()["unlit"][0].camera.rotation.numpy())
    _, opts, target, _ = cases()["unlit"]
    g = 2.0 * (demo[0]["unlit"]["image"] - target)
    jimg, jgrads = jax_grads_fast(jscene, jscene.options(SPEC.width, SPEC.height),
                                  jnp.asarray(g.numpy()),
                                  mesh=jax_make_mesh(RANKS, axis_name="bricks"))
    assert last_fallback_reason() is None
    for r in demo:
        np.testing.assert_allclose(r["unlit"]["image"].numpy(), np.asarray(jimg),
                                   atol=1e-6, rtol=1e-5)
    for key in ("emission", "absorption"):
        err = rel_err(joined(demo, "unlit", "grads", "grads", key), np.asarray(jgrads[key]))
        assert err <= TOL_JAX, f"{key}: {err:.3e} of the gradient's scale"


def test_lit_grids_match_the_single_device_scatter(demo):
    """Lit gradients against ``voxel_grads_fast`` (K6's plain version) on the
    whole scene, never against the JAX bricked backward (wrong when lit,
    ROADMAP section 3). The bricked relay rounds 1 - prod T, hence a
    tolerance: 1e-5 of scale for the grids and the parameters."""
    scene, opts, target, _ = cases()["lit"]
    g = 2.0 * (demo[0]["lit"]["image"] - target)
    _, want = voxel_grads_fast(scene, opts, g)
    for key, value in want.items():
        got = joined(demo, "lit", "grads", "grads", key)
        err = rel_err(got, value.numpy())
        assert err <= 1e-5, f"{key}: {err:.3e} of the gradient's scale"


def test_a_rank_refuses_another_ranks_brick():
    """Outside a process group the relay cannot run; a Brick of another
    rank is refused before any collective (one rank of one here)."""
    import os
    import tempfile

    import torch.distributed as dist

    scene, opts, _, _ = cases()["unlit"]
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize("file://" + os.path.join(tmp, "store"), 1, 0, device="cpu")
        try:
            brick = bricks.split_bricks(scene, make_mesh(2, "cpu")).bricks[1]
            with pytest.raises(ValueError, match="is not this rank's"):
                multihost.render_forward_bricked_ranks(brick, opts)
            np.testing.assert_array_equal(
                multihost.render_forward_bricked_ranks(scene, opts).numpy(),
                bricks.render_forward_bricked_fast(scene, opts, mesh=make_mesh(1, "cpu")).numpy())
        finally:
            dist.destroy_process_group()


def test_each_rank_holds_only_its_rows(demo):
    """Every grid of a rank's scene and of its kernel step's parameters is
    its own D / W rows: the ranks that matched the one-process path above
    held no whole grid."""
    rows = SPEC.volume // RANKS
    for r in demo:
        for case in multihost.BRICK_CASES:
            keys = ("emission", "absorption", "reflection") + (
                ("gradient_x", "gradient_y", "gradient_z") if case == "lookup" else ())
            assert r[case]["rows"] == {key: rows for key in keys}, case
        for case in STEPPED:
            for key in ("emission", "absorption"):
                assert r[case]["fast"]["params"][key].shape[0] == rows


def test_bricked_rehearsal_needs_a_card_or_the_cpu(monkeypatch):
    """Without a card and without ``device="cpu"`` the bricked rehearsal
    raises before it spawns a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.multiprocessing, "get_context",
                        lambda *a: pytest.fail("spawned ranks"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.run_demo(2, bricks=SPEC)
