"""Lit scenes with lookup gradient volumes through every fast gradient route,
on the CPU, where the kernels' wrappers run their plain versions: K6L and
K2L (``voxel_grads_fast``, ``transfer_grads_fast``, ``train_step_fast``),
the lookup gradient segment (``voxel_grads_bricked_fast``, the card sweep's
``voxel_grads_slabbed_fast``), rays-DP (``voxel_grads_fast_sharded``), the
planned step, and bands of image rows.

Scenes are 16^3 (the seeded blobs of ``make_scenes``, times 5 % seeded
noise, as every gradient cell of ``chip_smoke.py``: on a smooth volume the
lit angle adjoint amplifies rounding, tests/test_torch_smooth_shell.py),
24 x 20 images, in four forms: emission and the gradient volumes of one
shape with absorption aliased (the kernels' packed form), the same with
absorption separate, reflection aliased and two lights, gradient
volumes of another shape (the unpacked form), and the packed form with
absorption and reflection both of emission's shape (the kernels add their
cotangents as one float2).

Tolerances: the fast entry points equal ``replay_backward(angle_floor=True)``
to the bit (it is their plain version); ``jax.vjp`` of the JAX package's
``render_fused`` within 1e-3 of each key's scale (``tests/test_torch_grads.py``,
the two angle conventions); the multi-device and band routes within 1e-5
(1e-6 for bands) of scale of the single-device replay, whose sums they take
in another order. The card's streamed tier needs a card: ``chip_smoke.py``
holds its lookup step against ``voxel_grads_fast`` there.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.models.camera import Camera as JCamera
from volume_renderer_tpu.models.scene import RenderSettings as JSettings
from volume_renderer_tpu.models.scene import Scene as JScene
from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene

from test_torch_helpers import arrays_of, make_scenes
from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.api.planner import tier_bytes
from volume_renderer_tpu_torch.convert import scene_from_arrays
from volume_renderer_tpu_torch.models.volume import Volume
from volume_renderer_tpu_torch.ops import _build, cuda_bricks, cuda_grads, cuda_march, cuda_slab
from volume_renderer_tpu_torch.ops.cuda_grads import transfer_grads_fast, voxel_grads_fast
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.ops.vjp import replay_backward
from volume_renderer_tpu_torch.parallel import bricks, pallas_dp
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOL = (16, 16, 16)
W, H = 24, 20
NOISE = 0.05
LOOKUP_KEYS = ("gradient_x", "gradient_y", "gradient_z")
CASES = {
    "packed_absorption_aliased": dict(alias_absorption=True),
    "packed_reflection_aliased_two_lights": dict(alias_reflection=True, n_lights=2),
    "unpacked_other_shape": dict(other_shape=True),
    # absorption and reflection of emission's shape: the kernels' float2 pair
    "packed_both_own": dict(),
}
TOL_JAX = 1e-3       # of scale: tests/test_torch_grads.py's lit tolerance
TOL_ROUTE = 1e-5     # of scale: the same samples, summed in another order
TOL_BANDS = 1e-6


def jax_scene_of(a: dict) -> JScene:
    """The JAX package's scene of ``scene_from_arrays``' arrays."""
    es = tuple(a["element_size_um"])

    def vol(key):
        return None if a.get(key) is None else JVolume.create(a[key], es)

    s = {k: float(a[k]) for k in ("factor_emission", "factor_reflection", "factor_absorption",
                                  "opacity_threshold")}
    return JScene(
        emission=vol("emission"), absorption=vol("absorption"), reflection=vol("reflection"),
        gradient_x=vol("gradient_x"), gradient_y=vol("gradient_y"), gradient_z=vol("gradient_z"),
        illumination=jnp.asarray(a["illumination"]),
        light_positions=jnp.asarray(a["light_positions"]),
        light_colors=jnp.asarray(a["light_colors"]),
        camera=JCamera.create(rotation=a["rotation"], focal_length=a["focal_length"],
                              distance_to_object=a["distance_to_object"]),
        settings=JSettings.create(color=tuple(np.asarray(a["color"]).tolist()), **s))


@functools.lru_cache(maxsize=None)
def scenes(name, vol=VOL):
    """(JAX scene, port scene) of a case: ``make_scenes``' lit scene with its
    volumes times the seeded noise, and gradient volumes of the noisy
    emission (of its every other y and x voxel for the unpacked form)."""
    kw = dict(CASES[name])
    other = kw.pop("other_shape", False)
    jscene, _ = make_scenes(vol_shape=vol, lighting=True, rotate=(125.0, 25.0, 0.0), **kw)
    a = arrays_of(jscene)
    u = np.random.default_rng(16).random(vol, dtype=np.float32)
    factor = (np.float32(1.0) + np.float32(NOISE) * (u - np.float32(0.5))).astype(np.float32)
    for key in ("emission", "absorption", "reflection"):
        if a[key] is not None:
            a[key] = (a[key] * factor).astype(np.float32)
    src = a["emission"][:, ::2, ::2] if other else a["emission"]
    gradients = Volume.create(np.ascontiguousarray(src), device="cpu").gradient_volumes()
    a.update({key: v.data.numpy() for key, v in zip(LOOKUP_KEYS, gradients)})
    tscene = scene_from_arrays(a, device="cpu")
    assert tscene.has_lighting and tscene.has_gradient_volumes
    return jax_scene_of(a), tscene


def cotangent(seed=1):
    return (np.random.RandomState(seed).randn(H, W, 3) * 1e-3).astype(np.float32)


def of_scale(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def whole(value) -> torch.Tensor:
    return bricks.assemble(value) if isinstance(value, list) else value


@functools.lru_cache(maxsize=None)
def single(name):
    """(image, voxel_grads_fast) of the case for ``cotangent()``."""
    _, tscene = scenes(name)
    return voxel_grads_fast(tscene, tscene.options(W, H), cotangent())


@functools.lru_cache(maxsize=None)
def jax_grads(name):
    jscene, _ = scenes(name)
    diff, template = jax_split_scene(jscene)
    _, vjp_fn = jax.vjp(
        lambda d: jax_render_fused(jax_merge_scene(template, d), jscene.options(W, H)), diff)
    return {k: np.asarray(v) for k, v in vjp_fn(jnp.asarray(cotangent()))[0].items()}


# ---- single device: K6L, K2L -------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_fast_entry_points_are_the_floored_replay(name):
    _, tscene = scenes(name)
    opts = tscene.options(W, H)
    assert cuda_grads.grad_mode(tscene, True) == "K6L"
    assert cuda_grads.grad_mode(tscene, False) == "K2L"
    assert (cuda_march.pack_lookup(tscene) is None) == (name == "unpacked_other_shape")
    before = dict(cuda_march.LAUNCHES_BY_MODE)
    img, grads = single(name)
    img2, params = transfer_grads_fast(tscene, opts, cotangent(), image=img)
    assert img2 is img
    assert cuda_march.LAUNCHES_BY_MODE == before  # on the CPU no kernel launch is counted
    want = replay_backward(tscene, opts, torch.from_numpy(cotangent()), img, angle_floor=True)
    assert set(grads) == set(want) and set(LOOKUP_KEYS) <= set(grads)
    assert set(params) == set(cuda_grads.PARAM_KEYS)
    for key, value in want.items():
        np.testing.assert_array_equal(grads[key].numpy(), value.numpy(), err_msg=key)
        if key in params:
            np.testing.assert_array_equal(params[key].numpy(), value.numpy(), err_msg=key)
    for key in LOOKUP_KEYS:
        assert float(grads[key].abs().max()) > 0.0, key
        assert grads[key].shape == getattr(tscene, key).data.shape


@pytest.mark.parametrize("name", list(CASES))
def test_grads_match_the_jax_replay(name):
    """Every key, the gradient volumes' included, against ``jax.vjp`` of the
    JAX package's ``render_fused`` (the XLA replay that its fast entry
    points send a lit lookup scene to)."""
    img, grads = single(name)
    jscene, _ = scenes(name)
    jwant = jax_grads(name)
    assert set(grads) == set(jwant)
    np.testing.assert_allclose(
        img.numpy(), np.asarray(jax_render_fused(jscene, jscene.options(W, H))),
        rtol=1e-5, atol=1e-6)
    errs = {k: of_scale(grads[k].numpy(), v) for k, v in jwant.items()}
    assert max(errs.values()) <= TOL_JAX, errs


def test_train_step_fast_takes_the_replay_gradients():
    """One SGD step of ``train_step_fast`` (K5 + K6L on a card): its
    gradients are the floored replay's of the merged params, to the bit."""
    _, tscene = scenes("packed_reflection_aliased_two_lights")
    opts = tscene.options(W, H)
    target = render_forward_fast(tscene, opts)
    params, static = train.split_params(tscene)
    with torch.no_grad():
        params["emission"].mul_(1.2).add_(0.05)
    merged = train.merge_params({k: v.detach() for k, v in params.items()}, static)
    img = render_forward_fast(merged, opts)
    want = replay_backward(merged, opts, 2.0 * (img - target), img, angle_floor=True)
    loss = train.train_step_fast(params, torch.optim.SGD(list(params.values()), lr=1e-3),
                                 static, opts, target)
    assert float(loss) == float(torch.sum((img - target) ** 2))
    for key, p in params.items():
        np.testing.assert_array_equal(p.grad.numpy(), want[key].numpy(), err_msg=key)


# ---- the multi-device routes -------------------------------------------------


ROUTES = {
    "bricked": lambda s, o, g: bricks.voxel_grads_bricked_fast(s, o, g, mesh=make_mesh(4, "cpu")),
    "slabbed": lambda s, o, g: cuda_slab.voxel_grads_slabbed_fast(s, o, g, n_slabs=4),
    "dp": lambda s, o, g: pallas_dp.voxel_grads_fast_sharded(s, o, g, mesh=make_mesh(4, "cpu")),
}


@pytest.mark.parametrize("route,name", [("bricked", "packed_absorption_aliased"),
                                        ("bricked", "unpacked_other_shape"),
                                        ("slabbed", "packed_reflection_aliased_two_lights"),
                                        ("dp", "packed_reflection_aliased_two_lights")])
def test_routes_match_the_single_device_replay(route, name):
    """Every key of the route, the three gradient volumes' grids (cut,
    halo rows returned, or summed over the bands) among them, against the
    single-device replay and the JAX package's single-device replay; never
    against its bricked or DP gradients (wrong when lit, ROADMAP section 3)."""
    _, tscene = scenes(name)
    want_img, want = single(name)
    img, got = ROUTES[route](tscene, tscene.options(W, H), torch.from_numpy(cotangent()))
    np.testing.assert_allclose(img.numpy(), want_img.numpy(), rtol=1e-6, atol=1e-7)
    assert set(got) == set(want)
    errs = {k: of_scale(whole(v).numpy(), want[k].numpy()) for k, v in got.items()}
    assert max(errs.values()) <= TOL_ROUTE, errs
    errs = {k: of_scale(whole(got[k]).numpy(), v) for k, v in jax_grads(name).items()}
    assert max(errs.values()) <= TOL_JAX, errs


def test_planned_bricked_step_follows_train_step_fast():
    """``train_step_planned`` (Adam) under a budget below the whole-grid
    tier, with a mesh of 8: the bricked tier (the lookup gradient segment a
    brick) steps as ``train_step_fast`` does. A deeper volume and a smaller image,
    so that a brick holds less than the whole grids and the rays' state."""
    _, tscene = scenes("packed_absorption_aliased", (32, 16, 16))
    opts = tscene.options(12, 10)
    target = render_forward_fast(tscene, opts)
    mesh = make_mesh(8, "cpu")
    runs = []
    for planned in (True, False):
        params, static = train.split_params(tscene)
        with torch.no_grad():
            params["emission"].mul_(1.2).add_(0.05)
        opt = torch.optim.Adam(list(params.values()), lr=1e-3)
        if planned:
            bricked = tier_bytes(train.merge_params(params, static), opts, "bricked",
                                 n_devices=len(mesh), training=True, optimizer=opt,
                                 device="cpu")
            loss, plan = train.train_step_planned(params, opt, static, opts, target,
                                                  budget_bytes=int(bricked / 0.7) + 2,
                                                  mesh=mesh, device="cpu")
            assert plan.path == "bricked", plan
        else:
            loss = train.train_step_fast(params, opt, static, opts, target)
        runs.append((float(loss), params))
    (loss, params), (want_loss, want) = runs
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for key, p in want.items():
        np.testing.assert_allclose(params[key].detach().numpy(), p.detach().numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=key)


# ---- bands of image rows ------------------------------------------------------


def test_bands_of_rows_sum_to_the_whole_launch():
    """``voxel_grads_fast`` over three bands into shared grids (``grids=``,
    as rays-DP launches K6L) and ``brick_gradients`` over two bands of the
    last brick (as a rows x bricks rank launches the lookup segment), summed,
    against the whole launch's."""
    _, tscene = scenes("packed_reflection_aliased_two_lights")
    opts = tscene.options(W, H)
    g = torch.from_numpy(cotangent())
    img, want = single("packed_reflection_aliased_two_lights")
    grids = cuda_grads.zero_grids(tscene)
    assert set(LOOKUP_KEYS) <= set(grids)
    params = {}
    for y0, rows in ((0, 7), (7, 7), (14, 6)):
        _, part = voxel_grads_fast(tscene, opts, g[y0:y0 + rows], image=img[y0:y0 + rows],
                                   y_offset=y0, n_rows=rows, grids=grids)
        for key, value in part.items():
            if key not in grids:
                params[key] = value if key not in params else params[key] + value
    for key, value in want.items():
        got = grids[key] if key in grids else params[key]
        assert of_scale(got.numpy(), value.numpy()) <= TOL_BANDS, key

    split = bricks.split_bricks(tscene, make_mesh(4, "cpu"))
    fwd = bricks._forward(split, opts, 0.0, fast=True)
    up = bricks._upstream([cuda_bricks.brick_march.own_dot(g, own) for own in fwd.own],
                          fwd.ascending, torch.cumsum, 0.0)
    b = 3
    brick = split.bricks[b]
    whole_launch = cuda_bricks.brick_gradients(brick, opts, 0.0, g, fwd.image, fwd.w_in[b], up[b],
                                               fwd.entry[b])
    summed = {}
    for y0, rows in ((0, 10), (10, 10)):
        _, entry = cuda_bricks.brick_transmittance(brick, opts, y_offset=y0, n_rows=rows)
        cut = slice(y0, y0 + rows)
        part = cuda_bricks.brick_gradients(
            brick, opts, 0.0, g[cut].contiguous(), fwd.image[cut].contiguous(),
            fwd.w_in[b][cut].contiguous(), up[b][cut].contiguous(), entry, y_offset=y0,
            n_rows=rows)
        for key, value in part.items():
            summed[key] = value if key not in summed else summed[key] + value
    assert set(summed) == set(whole_launch) and set(LOOKUP_KEYS) <= set(summed)
    for key, value in whole_launch.items():
        assert of_scale(summed[key].numpy(), value.numpy()) <= TOL_BANDS, key


# ---- chip_smoke.py's reading of the lookup kernels ------------------------------


def test_chip_smoke_reads_the_lookup_kernels():
    """chip_smoke's ptxas reading maps K2L's, K6L's and the lookup gradient
    segment's kernels (packed, with and without the float2 pair, and
    unpacked under their own cap) to their modes and blocks, K2L's in 16 x
    kK2LRows; its operation
    count of a lookup backward step is the lit step's with K5's three
    gradient fetches for the six taps and four 8-corner scatters for the
    tap window's."""
    import chip_smoke

    instantiations = (("30march_bwd_lookup_params_kernel", "Lb0ELb0ELb0E", 120),
                      ("30march_bwd_lookup_params_kernel", "Lb0ELb0ELb1E", 110),
                      ("39march_bwd_lookup_unpacked_params_kernel", "Lb1ELb0E", 150),
                      ("31march_bwd_lookup_scatter_kernel", "Lb0ELb1ELb0E", 168),
                      ("31march_bwd_lookup_scatter_kernel", "Lb0ELb0ELb1E", 160),
                      ("40march_bwd_lookup_unpacked_scatter_kernel", "Lb0ELb0E", 192),
                      ("23brick_lookup_bwd_kernel", "Lb1ELb1ELb0E", 160),
                      ("32brick_lookup_unpacked_bwd_kernel", "Lb0ELb0E", 190))
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{kernel}I{args}EEv8GradArgs' "
        "for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {registers} registers, used 0 barriers, 560 bytes cmem[0]"
        for kernel, args, registers in instantiations)
    threads = chip_smoke.kernel_threads(chip_smoke.REPO)
    got = chip_smoke.ptxas_by_kernel(log, threads=threads)
    assert set(got) == {
        "K2L march_bwd_lookup_params_kernel<0,0,0>", "K2L march_bwd_lookup_params_kernel<0,0,1>",
        "K2L march_bwd_lookup_unpacked_params_kernel<1,0>",
        "K6L march_bwd_lookup_scatter_kernel<0,1,0>", "K6L march_bwd_lookup_scatter_kernel<0,0,1>",
        "K6L march_bwd_lookup_unpacked_scatter_kernel<0,0>",
        "K7_scatter_lookup brick_lookup_bwd_kernel<1,1,0>",
        "K7_scatter_lookup brick_lookup_unpacked_bwd_kernel<0,0>"}
    assert got["K6L march_bwd_lookup_scatter_kernel<0,1,0>"]["blocks_per_sm"] == 3
    assert got["K6L march_bwd_lookup_unpacked_scatter_kernel<0,0>"]["blocks_per_sm"] == 2
    source = (_build.CSRC_DIR / "march_bwd.cu").read_text()
    k2l_rows = int(source.split("constexpr int kK2LRows = ")[1].split(";")[0])
    for args in ("0,0,0", "0,0,1"):
        assert (got[f"K2L march_bwd_lookup_params_kernel<{args}>"]["threads"]
                == threads["march_bwd_lookup_params_kernel"] == 16 * k2l_rows)
    assert (got["K2L march_bwd_lookup_unpacked_params_kernel<1,0>"]["threads"]
            == threads["march_bwd_lookup_unpacked_params_kernel"] == 16 * k2l_rows)
    for n_lights in (1, 2):
        for ab, re in ((False, False), (True, False), (False, True), (True, True)):
            lit = chip_smoke.bwd_flops_per_step(True, True, ab, re, n_lights)
            lookup = chip_smoke.bwd_flops_per_step(True, True, ab, re, n_lights, lookup=True)
            eight = 0 if (ab and re) else chip_smoke._X_WEIGHTS
            assert lookup - lit == (chip_smoke._STEP_LOOKUP_TAPS - chip_smoke._STEP_OTF_TAPS
                                    + 4 * chip_smoke._SCATTER - chip_smoke._EM_TAPS_SCATTER
                                    + chip_smoke._X_WEIGHTS - eight)
            assert (chip_smoke.bwd_flops_per_step(True, False, ab, re, n_lights, lookup=True)
                    - chip_smoke.bwd_flops_per_step(True, False, ab, re, n_lights)
                    == chip_smoke._STEP_LOOKUP_TAPS - chip_smoke._STEP_OTF_TAPS)
            assert (chip_smoke.brick_flops_per_sample("scatter_lit", ab, re, lookup=True,
                                                      n_lights=n_lights) == lookup + 5)


def distinct_corners(s, dims) -> torch.Tensor:
    """Per sample, the distinct voxels among its 8 clamped corners in a grid
    of ``dims`` (x, y, z): their addresses, sorted, counted where they
    change."""
    lo, hi = [], []
    for c, n in zip(s, dims):
        i = torch.clamp(torch.floor(c * float(n) - 0.5), -1.0, float(n)).long()
        lo.append(torch.clamp(i, 0, n - 1))
        hi.append(torch.clamp(i + 1, 0, n - 1))
    w, h, _ = dims
    addr = torch.stack([x + w * (y + h * z) for z in (lo[2], hi[2]) for y in (lo[1], hi[1])
                        for x in (lo[0], hi[0])], dim=-1).sort(dim=-1).values
    return 1 + (addr[:, 1:] != addr[:, :-1]).sum(dim=-1)


def distinct_sectors(s, dims, elem) -> torch.Tensor:
    """Per sample, the distinct 32-byte sectors among its 8 clamped corners
    in a grid of ``dims`` (x, y, z) and ``elem`` bytes a voxel, x fastest:
    their byte addresses over 32, sorted, counted where they change."""
    lo, hi = [], []
    for c, n in zip(s, dims):
        i = torch.clamp(torch.floor(c * float(n) - 0.5), -1.0, float(n)).long()
        lo.append(torch.clamp(i, 0, n - 1))
        hi.append(torch.clamp(i + 1, 0, n - 1))
    w, h, _ = dims
    sec = torch.stack([(x + w * (y + h * z)) * elem // 32 for z in (lo[2], hi[2])
                       for y in (lo[1], hi[1]) for x in (lo[0], hi[0])], dim=-1)
    sec = sec.sort(dim=-1).values
    return 1 + (sec[:, 1:] != sec[:, :-1]).sum(dim=-1)


@pytest.mark.parametrize(
    "name,count", [pytest.param(n, "adds", id=n) for n in CASES]
    + [pytest.param(n, "widths", id=f"{n}-widths_and_sectors") for n in CASES])
def test_chip_smoke_counts_the_lookup_scatter_from_the_walk(name, count):
    """``chip_smoke.march_scatter_adds`` (K6L; over the plain march's samples
    or a given samples plane) and ``lookup_scatter_adds`` (the lookup
    gradient segment) count, from the plain walk, 8 atomic adds
    a sample for emission, each gradient volume and each role not aliased
    to emission; the voxels those adds reach equal a count of each sample's
    distinct clamped corners; the four bricks' walks take the single-device
    march's samples and reach as many voxels. The ``widths`` cases: where
    the pack exists, the four cotangents of emission and the gradient
    volumes go out as 8 float4 reductions a sample (32 scalar adds
    otherwise), absorption's and reflection's as 8 float2 ones beside it
    where both have emission's shape, any other role's as 8 scalar ones;
    the 32-byte sectors they reach, and those the scalar adds into each grid
    would reach, equal a count of the distinct sectors of each sample's
    corners (``distinct_sectors``), at most two a row pair of the float4
    accumulator, fewer than the four scalar grids', and the bricks' sum is
    the single device's."""
    import chip_smoke
    from volume_renderer_tpu_torch.ops import raymarch_core as core

    _, tscene = scenes(name)
    opts = tscene.options(W, H)
    grids = ["emission", *LOOKUP_KEYS] + [
        k for k, aliased in (("absorption", tscene.absorption_aliased),
                             ("reflection", tscene.reflection_aliased)) if not aliased]
    counted = chip_smoke.march_scatter_adds(tscene, opts)
    n = counted["samples"]
    consts, pos, step, steps = chip_smoke.march_samples(tscene, opts)
    assert n == int(steps.sum()) > 0
    if count == "widths":
        packed = cuda_march.pack_lookup(tscene) is not None
        assert packed == (name != "unpacked_other_shape")
        paired = packed and cuda_grads.has_pair(tscene)
        assert paired == (name == "packed_both_own")
        pack, pair = "+".join(["emission", *LOOKUP_KEYS]), "absorption+reflection"
        vector = (("emission", *LOOKUP_KEYS) if packed else ()) + (
            ("absorption", "reflection") if paired else ())
        scalar = [k for k in grids if k not in vector]
        assert counted["reductions"] == {"float4": 8 * n * packed, "float2": 8 * n * paired,
                                         "scalar": 8 * n * len(scalar)}
        assert counted["reductions_per_sample"] == {
            "float4": 8.0 * packed, "float2": 8.0 * paired, "scalar": 8.0 * len(scalar)}
        targets = {pack: 16} if packed else {}
        targets.update({pair: 8} if paired else {})
        targets.update({k: 4 for k in scalar})
        assert set(counted["sectors"]) == set(targets)
        sectors, scalar = dict.fromkeys(targets, 0), dict.fromkeys(grids, 0)
        for k in range(int(steps.max())):
            act = steps > k
            s = [c[act] for c in core.to_sample_coords(pos, consts)]
            for counts, elems in ((sectors, targets), (scalar, dict.fromkeys(grids, 4))):
                for key, elem in elems.items():
                    v = getattr(tscene, key.split("+")[0]).data
                    dims = (v.shape[2], v.shape[1], v.shape[0])
                    counts[key] += int(distinct_sectors(s, dims, elem).sum())
            pos = pos + step
        assert counted["sectors"] == sectors and counted["sectors_scalar"] == scalar
        assert counted["sectors_per_sample"] == sum(sectors.values()) / n
        assert counted["sectors_per_sample_scalar"] == sum(scalar.values()) / n
        if packed:  # at most 2 a row pair, fewer than the four float32 grids reach
            assert sectors[pack] <= 8 * n
            assert sectors[pack] < sum(scalar[k] for k in ("emission", *LOOKUP_KEYS))
        if paired:
            assert sectors[pair] <= scalar["absorption"] + scalar["reflection"]
        consts, pos, step, steps = chip_smoke.march_samples(tscene, opts)
    assert chip_smoke.march_scatter_adds(tscene, opts, steps.reshape(H, W)) == counted
    assert counted["adds"] == {k: 8 * n for k in grids}
    assert counted["atomic_adds_per_sample"] == 8 * len(grids)
    voxels = dict.fromkeys(grids, 0)
    for k in range(int(steps.max())):
        act = steps > k
        s = core.to_sample_coords(pos, consts)
        for key in grids:
            v = getattr(tscene, key).data
            reach = distinct_corners([c[act] for c in s], (v.shape[2], v.shape[1], v.shape[0]))
            voxels[key] += int(reach.sum())
        pos = pos + step
    assert counted["voxels"] == voxels
    assert all(n <= v < 8 * n for v in voxels.values())

    split = bricks.split_bricks(tscene, make_mesh(4, "cpu"))
    fwd = bricks._forward(split, opts, 0.0, fast=True)
    parts = [chip_smoke.lookup_scatter_adds(b, opts, w, e)
             for b, w, e in zip(split.bricks, fwd.w_in, fwd.entry)]
    assert sum(p["samples"] for p in parts) == n
    if count == "widths":
        for key in ("reductions", "sectors", "sectors_scalar"):
            assert {k: sum(p[key][k] for p in parts) for k in counted[key]} == counted[key]
        return
    for p in parts:
        assert p["adds"] == {k: 8 * p["samples"] for k in grids}
    assert {k: sum(p["voxels"][k] for p in parts) for k in grids} == voxels
