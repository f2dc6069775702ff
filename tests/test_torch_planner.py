"""The port's memory planner (``api/planner.py``) and the routes it opens:
the tier ladder with budgets stated through the port's own estimates
(``tier_bytes``), on a card and on the CPU; the real brick halo against
the JAX planner's; a depth-1 reflection volume with a mesh; the
``ValueError`` when nothing fits; the facade's routes (``last_plan``, the
image against the whole-grid path, ``mem_info`` against the JAX facade's);
and ``train.train_step_planned``'s routes.

Planning reads shapes only, so the card's ladder is planned here too
(``device="cuda"`` with a budget given); the routes run on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import volume_renderer_tpu.api.renderer as jax_renderer_mod
from volume_renderer_tpu.api.planner import plan_render as jax_plan_render
from volume_renderer_tpu.api.planner import ray_state_bytes as jax_ray_state_bytes
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.parallel.sharding import make_mesh as jax_make_mesh

import volume_renderer_tpu_torch.api.renderer as renderer_mod
from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch import Volume, VolumeRenderer, train
from volume_renderer_tpu_torch.api import planner
from volume_renderer_tpu_torch.api.planner import RenderPlan, plan_render, tier_bytes
from volume_renderer_tpu_torch.ops.brick_march import HALO
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOL = (16, 12, 10)       # scenes that are rendered
PLAN_VOL = (64, 24, 20)  # scenes that are only planned: grids larger than the rays' state
W, H = 16, 12
ONE = dict(headroom=1.0)


def _streamed_choice(scene, opts, budget, **kw):
    """The slab count of the first streamed tier that fits ``budget``."""
    for n in planner._divisors(scene.emission.data.shape[0])[1:]:
        est = tier_bytes(scene, opts, "streamed", n_slabs=n, **kw)
        if est is not None and est <= budget:
            return n, est
    return None


def test_ladder_on_a_card():
    _, scene = make_scenes(vol_shape=PLAN_VOL)
    opts = scene.options(W, H)
    cuda = tier_bytes(scene, opts, "cuda")
    assert cuda == planner.scene_volume_bytes(scene) + W * H * 4 * 4
    assert plan_render(scene, opts, budget_bytes=cuda, device="cuda", **ONE) == RenderPlan(
        "cuda", 1, cuda, cuda)
    # unlit, the slabbed sweep holds the grids and more per-ray state than
    # the kernel: the card's ladder goes from "cuda" to "streamed"
    for n in planner._divisors(64)[1:]:
        assert tier_bytes(scene, opts, "slabbed", n_slabs=n) > cuda
    budget = cuda - 1
    plan = plan_render(scene, opts, budget_bytes=budget, device="cuda", **ONE)
    n, est = _streamed_choice(scene, opts, budget)
    assert (plan.path, plan.n_slabs, plan.est_bytes) == ("streamed", n, est)
    # the streamed tier: two windows a role and the sweep's rays
    win = 2 * (64 // n + 2 * HALO) * 24 * 20 * 4
    assert est == 2 * win + planner.ray_state_bytes(opts, "sweep")
    hopeless = min(tier_bytes(scene, opts, "streamed", n_slabs=k)
                   for k in planner._divisors(64)[1:]) - 1
    with pytest.raises(ValueError, match="budget"):
        plan_render(scene, opts, budget_bytes=hopeless, device="cuda", **ONE)
    # the headroom discounts the budget
    assert plan_render(scene, opts, budget_bytes=int(cuda / 0.7) + 1, device="cuda").path == "cuda"


def test_ladder_with_a_mesh():
    _, scene = make_scenes(vol_shape=PLAN_VOL)
    opts = scene.options(W, H)
    mesh = make_mesh(4, "cpu")
    cuda = tier_bytes(scene, opts, "cuda_dp")
    plan = plan_render(scene, opts, budget_bytes=cuda, mesh=mesh, device="cuda", **ONE)
    assert (plan.path, plan.n_devices) == ("cuda_dp", 4) and "n_devices=4" in str(plan)
    brick = tier_bytes(scene, opts, "bricked", n_devices=4)
    assert brick < cuda
    plan = plan_render(scene, opts, budget_bytes=brick, mesh=mesh, device="cuda", **ONE)
    assert (plan.path, plan.est_bytes, plan.n_devices) == ("bricked", brick, 4)
    # the same budget without the mesh: a single-device sweep
    assert plan_render(scene, opts, budget_bytes=brick, device="cuda", **ONE).path == "streamed"
    # bricks thinner than HALO rows: no bricked tier
    assert tier_bytes(scene, opts, "bricked", n_devices=64) is None


def test_slabbed_saves_the_lookup_pack():
    """A lit lookup scene's render packs four grids (K5); the slabbed sweep
    does not, so a budget between the two picks it."""
    _, scene = make_scenes(vol_shape=PLAN_VOL, lighting=True, gradient_volumes=True)
    opts = scene.options(W, H)
    cuda = tier_bytes(scene, opts, "cuda")
    assert cuda - planner._pack_bytes(scene) < tier_bytes(scene, opts, "slabbed", n_slabs=2) < cuda
    plan = plan_render(scene, opts, budget_bytes=cuda - 1, device="cuda", **ONE)
    assert (plan.path, plan.n_slabs) == ("slabbed", 2)


def test_training_budgets_the_lookup_gradient_grids():
    """A lit lookup scene's training step scatters into the three gradient
    volumes' grids too (K6L, the lookup gradient segment), through a float4
    accumulator of four grids beside them, and absorption's and
    reflection's, separate and of emission's shape here, through a float2
    one of two: on every tier its estimate exceeds the same scene's with
    on-the-fly gradients, above what rendering adds, by those grids and the
    accumulators (or the windows the tier holds of them). Under a budget just below the whole-grid step the card's
    planner picks the slabbed sweep, which holds no pack and no whole-grid
    state."""
    _, otf = make_scenes(vol_shape=VOL, lighting=True)
    _, lookup = make_scenes(vol_shape=VOL, lighting=True, gradient_volumes=True)
    opts = lookup.options(W, H)
    d, h, w = VOL
    grid = d * h * w * 4
    slots = planner.optimizer_slots()

    def added(scene, path, **kw):
        return (tier_bytes(scene, opts, path, training=True, **kw)
                - tier_bytes(scene, opts, path, **kw))

    window = (d // 2 + 2 * HALO) * h * w * 4
    brick = (d // 4 + 2 * HALO) * h * w * 4
    want = {("cuda", ()): (3 + 6) * grid, ("cuda_dp", ()): (3 + 6) * grid,
            ("bricked", (("n_devices", 4),)): (1 + slots) * 3 * brick + 6 * brick,
            ("slabbed", (("n_slabs", 2),)): 3 * grid + (3 + 6) * window,
            ("streamed", (("n_slabs", 2),)): (3 + 6) * window}
    for (path, kw), extra in want.items():
        assert added(lookup, path, **dict(kw)) - added(otf, path, **dict(kw)) == extra, path
    whole = tier_bytes(lookup, opts, "cuda", training=True)
    plan = plan_render(lookup, opts, budget_bytes=whole - 1, training=True, device="cuda", **ONE)
    assert plan.path == "slabbed" and plan.est_bytes <= plan.budget_bytes, plan
    assert plan.est_bytes == tier_bytes(lookup, opts, "slabbed", n_slabs=plan.n_slabs,
                                        training=True)


def test_ladder_on_the_cpu():
    _, scene = make_scenes(vol_shape=VOL)
    opts = scene.options(W, H)
    plain = tier_bytes(scene, opts, "plain", device="cpu")
    assert plan_render(scene, opts, budget_bytes=plain, **ONE).path == "plain"
    # a mesh of CPU devices: the whole-grid tier still fits one device
    assert plan_render(scene, opts, budget_bytes=plain, mesh=make_mesh(4, "cpu"),
                       **ONE).path == "plain"
    plan = plan_render(scene, opts, budget_bytes=plain - 1, **ONE)
    assert plan.path == "streamed"
    assert plan.est_bytes == _streamed_choice(scene, opts, plain - 1, device="cpu")[1]
    assert planner.device_memory_budget("cpu") == 12 * 2 ** 30


def test_training_budgets_grads_and_optimizer_state():
    _, scene = make_scenes(vol_shape=VOL)
    opts = scene.options(W, H)
    grid = 16 * 12 * 10 * 4
    render = tier_bytes(scene, opts, "cuda")
    adam = tier_bytes(scene, opts, "cuda", training=True)
    # emission, absorption and reflection gradient grids, Adam's two moments
    # of emission and absorption, and the backward's per-ray planes
    assert adam - render == 3 * grid + 2 * 2 * grid + W * H * 4 * (24 - 4)
    params, _ = train.split_params(scene)
    sgd = torch.optim.SGD(list(params.values()), lr=1.0)
    assert planner.optimizer_slots(sgd) == 0
    assert planner.optimizer_slots(torch.optim.SGD(list(params.values()), lr=1.0,
                                                   momentum=0.9)) == 1
    adam_opt = torch.optim.Adam(list(params.values()))
    assert planner.optimizer_slots(adam_opt) == planner.optimizer_slots() == 2
    for p in params.values():  # after a step, its state is counted
        p.grad = torch.ones_like(p)
    adam_opt.step()
    assert planner.optimizer_slots(adam_opt) == 2
    assert tier_bytes(scene, opts, "cuda", training=True, optimizer=sgd) == adam - 2 * 2 * grid


def test_brick_halo_against_the_jax_planner():
    """A brick holds 2 HALO rows beyond its own; the JAX planner budgets 2."""
    jscene, tscene = make_scenes(vol_shape=(32, 12, 10))
    jopts, opts = jscene.options(W, H), tscene.options(W, H)
    n = 4
    vol = planner.scene_volume_bytes(tscene)
    budget = jax_ray_state_bytes(jopts) + vol * 2 // 3
    jplan = jax_plan_render(jscene, jopts, budget_bytes=budget, mesh=jax_make_mesh(
        n, axis_name="bricks"), **ONE)
    assert jplan.path == "bricked"
    jax_brick = (jplan.est_bytes - jax_ray_state_bytes(jopts)) // 2
    port_brick = planner.brick_grid_bytes(tscene, n)
    rows = 12 * 10 * 4
    assert jax_brick == 2 * (32 // n + 2) * rows
    # two volumes (emission, absorption), 2 more rows each
    assert port_brick - jax_brick == 2 * 2 * rows, (port_brick, jax_brick)


def test_depth_one_reflection_volume_with_a_mesh():
    """A lit scene whose reflection is the (1, 1, 1) default: the JAX planner
    denies it the bricks (and every slab count), the port copies it whole to
    every brick."""
    jscene, tscene = make_scenes(vol_shape=PLAN_VOL, lighting=True)
    one = np.ones((1, 1, 1), np.float32)
    jscene = jscene.replace(reflection=JVolume.create(one))
    tscene = tscene.replace(reflection=Volume.create(one, device="cpu"))
    opts = tscene.options(W, H)
    brick = tier_bytes(tscene, opts, "bricked", n_devices=4)
    assert brick == planner.brick_grid_bytes(tscene, 4) + 16 ** 3 * 4 + planner.ray_state_bytes(
        opts, "sweep") + 2 * 4 * W * H * 4
    plan = plan_render(tscene, opts, budget_bytes=brick, mesh=make_mesh(4, "cpu"),
                       device="cuda", **ONE)
    assert plan.path == "bricked"
    with pytest.raises(ValueError, match="budget"):
        jax_plan_render(jscene, jscene.options(W, H), budget_bytes=brick,
                        mesh=jax_make_mesh(4, axis_name="bricks"), **ONE)


# ---- the facade ----------------------------------------------------------------


def _renderer(lib_volume, renderer, d=16):
    rng = np.random.default_rng(3)
    em = rng.random((d, 12, 10)).astype(np.float32)
    r = renderer()
    r.volume_emission = lib_volume(em)
    r.volume_absorption = lib_volume(em * 0.5)
    r.focal_length, r.distance_to_object = 3.0, 6.0
    r.rotate(30, -20, 10)
    r.image_resolution = (W, H)
    return r


def _port_renderer(d=16):
    return _renderer(lambda a: Volume.create(a, device="cpu"),
                     lambda: VolumeRenderer(device="cpu"), d)


def test_facade_routes_by_budget_and_mesh():
    r = _port_renderer()
    flat = r.render()
    assert r.last_plan.path == "plain"
    scene = r._build_scene()
    opts = scene.options(W, H)
    plain = tier_bytes(scene, opts, "plain", device="cpu")
    r.memory_budget_bytes = int((plain - 1) / 0.7)
    img = r.render()
    assert r.last_plan.path == "streamed" and r.last_plan.n_slabs > 1
    np.testing.assert_allclose(img.numpy(), flat.numpy(), rtol=5e-4, atol=1e-5)
    r.mesh = make_mesh(4, "cpu")
    img = r.render()
    assert (r.last_plan.path, r.last_plan.n_devices) == ("bricked", 4)
    np.testing.assert_allclose(img.numpy(), flat.numpy(), rtol=5e-4, atol=1e-5)
    r.memory_budget_bytes = None
    img = r.render()
    assert r.last_plan.path == "plain"
    np.testing.assert_array_equal(img.numpy(), flat.numpy())


@pytest.mark.parametrize("path", ["cuda_dp", "slabbed"])
def test_facade_forced_routes_render_the_flat_image(path, monkeypatch):
    """The routes the CPU ladder does not reach, forced: the bands of rays-DP
    and the plain slab sweep give the whole-grid image."""
    r = _port_renderer()
    flat = r.render()
    forced = RenderPlan(path, 4 if path == "slabbed" else 1, n_devices=4 if path == "cuda_dp" else 1)
    monkeypatch.setattr(renderer_mod, "plan_render", lambda *a, **kw: forced)
    r.mesh = make_mesh(4, "cpu")
    img = r.render()
    assert r.last_plan is forced
    np.testing.assert_allclose(img.numpy(), flat.numpy(), rtol=5e-4, atol=1e-5)


def test_mem_info_matches_the_jax_facade():
    port = _port_renderer()
    jax = _renderer(JVolume.create, jax_renderer_mod.VolumeRenderer)
    for r, lib in ((port, lambda a: Volume.create(a, device="cpu")), (jax, JVolume.create)):
        em = np.asarray(r.volume_emission.data)
        r.volume_reflection = lib(em.copy())  # equal to emission: shared
        r.volume_gradient_x = r.volume_gradient_y = r.volume_gradient_z = lib(em * 0.1)
    got, want = port.mem_info().splitlines(), jax.mem_info().splitlines()
    volume_lines = [line for line in want if line.startswith("  volume_") or "total" in line]
    assert len(volume_lines) == 7 and "(shared with volume_emission)" in volume_lines[2]
    assert got[1:1 + len(volume_lines)] == volume_lines
    assert got[0] == "volume_renderer_tpu_torch scene memory:" and len(got) == 8


# ---- train_step_planned -----------------------------------------------------------


def _fit(d=16):
    _, scene = make_scenes(vol_shape=(d, 12, 10), rotate=(88.0, 0.0, 0.0))
    opts = scene.options(W, H)
    target = torch.from_numpy(np.asarray(renderer_mod.render_forward_fast(scene, opts)))
    params, static = train.split_params(scene)
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
    return params, static, opts, target


def _copy(params):
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


@pytest.mark.parametrize("route", ["plain", "streamed", "bricked"])
def test_train_step_planned_routes(route):
    params, static, opts, target = _fit()
    mesh = make_mesh(4, "cpu") if route == "bricked" else None
    budget = None
    if route != "plain":
        budget = tier_bytes(train.merge_params(params, static), opts, "plain", training=True,
                            device="cpu") - 1
    twin = _copy(params)
    opt = torch.optim.SGD(list(params.values()), lr=1e-2)
    loss, plan = train.train_step_planned(params, opt, static, opts, target, budget_bytes=budget,
                                          mesh=mesh, device="cpu")
    assert plan.path == route, plan
    # the same step through the tier's own entry point
    twin_opt = torch.optim.SGD(list(twin.values()), lr=1e-2)
    if route == "plain":
        want = train.train_step(twin, twin_opt, static, opts, target)
    elif route == "streamed":
        want = train.train_step_streamed(twin, twin_opt, static, opts, target,
                                         n_slabs=plan.n_slabs, device="cpu")
    else:
        want = bricks.train_step_fast_bricked(twin, twin_opt, static, opts, target, mesh=mesh)
    assert float(loss) == float(want)
    for key, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), twin[key].detach().numpy())
        assert not torch.equal(p.grad, torch.zeros_like(p.grad)) or key == "factor_reflection"


def test_train_step_planned_bricked_follows_the_whole_step():
    """The bricked tier's step with whole params equals the single-device
    kernel step's (here their plain passes), gradient for gradient."""
    params, static, opts, target = _fit()
    twin = _copy(params)
    bricks.train_step_fast_bricked(params, torch.optim.SGD(list(params.values()), lr=0.0),
                                   static, opts, target, mesh=make_mesh(4, "cpu"))
    train.train_step_fast(twin, torch.optim.SGD(list(twin.values()), lr=0.0), static, opts,
                          target)
    for key, p in params.items():
        scale = float(twin[key].grad.abs().max()) or 1.0
        assert float((p.grad - twin[key].grad).abs().max()) <= 1e-5 * scale, key


def test_train_step_planned_refuses_grids_on_another_device():
    params, static, opts, target = _fit()
    opt = torch.optim.SGD(list(params.values()), lr=1e-2)
    with pytest.raises(ValueError, match="tier takes the grids on cuda"):
        train.train_step_planned(params, opt, static, opts, target, budget_bytes=2 ** 30,
                                 device="cuda")
