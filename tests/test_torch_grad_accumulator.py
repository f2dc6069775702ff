"""The gradient accumulators of K6L and the lookup gradient segment, on the
CPU: the plain unpack (``ops.cuda_grads.unpack_accumulator``), accumulators
shared by several bands and unpacked once a device
(``parallel/pallas_dp.py``), and the planner's bytes for them.

On a card the two kernels add a lit lookup scene's emission and gradient
volume cotangents into one (D, H, W, 4) accumulator laid out as K5's pack
and, where absorption and reflection are separate and of emission's shape,
theirs into one (D, H, W, 2), a vector reduction a corner each; the wrapper
unpacks them into the grids that the API returns. The kernels need a card
(``chip_smoke.py`` holds them against the plain replay there); here the
accumulators are filled as they fill them, from the plain replay's grids of
each band, interleaved as the pack is and added in.

Scenes are 16^3 with 5 % seeded noise (the gradient tests' amount), 24 x 20
images. Tolerances: the unpack is exact (one add a value); a sum over bands
within 1e-6 of scale of the whole image's replay (the same samples, summed
in another order), rays-DP within 1e-5, the JAX package's replay within 1e-3 of scale
(``tests/test_torch_grads.py``'s lit tolerance, the two angle conventions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.vjp import merge_scene as jax_merge_scene
from volume_renderer_tpu.ops.vjp import render_fused as jax_render_fused
from volume_renderer_tpu.ops.vjp import split_scene as jax_split_scene

from test_torch_helpers import make_scenes
from test_torch_lookup_grads import scenes
from volume_renderer_tpu_torch.api import planner
from volume_renderer_tpu_torch.api.planner import tier_bytes
from volume_renderer_tpu_torch.ops import cuda_march
from volume_renderer_tpu_torch.ops.brick_march import HALO
from volume_renderer_tpu_torch.ops.cuda_grads import (
    PACK_KEYS, PAIR_KEYS, has_pair, unpack_accumulator, voxel_grads_fast, zero_grids)
from volume_renderer_tpu_torch.ops.vjp import replay_backward
from volume_renderer_tpu_torch.parallel import pallas_dp
from volume_renderer_tpu_torch.parallel.mesh import make_mesh
from volume_renderer_tpu_torch.parallel.sharding import bands

torch.set_num_threads(1)

VOL = (16, 16, 16)  # test_torch_lookup_grads.scenes'
PLAN_VOL = (64, 24, 20)  # scenes that are only planned
W, H = 24, 20
TOL_BANDS = 1e-6
TOL_ROUTE = 1e-5  # rays-DP: the bands' parameter sums summed on mesh[0]
TOL_JAX = 1e-3


def cotangent(seed=1):
    return (np.random.RandomState(seed).randn(H, W, 3) * 1e-3).astype(np.float32)


def of_scale(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_unpack_adds_the_four_channels_into_the_grids():
    """Each channel c of a float4 accumulator is added into
    ``grids[PACK_KEYS[c]]`` in place, bit for bit what ``add_`` of that
    channel gives, of a float2 one into ``grids[PAIR_KEYS[c]]``; a key the
    grids lack is made a contiguous grid of its own; the other grids are
    left alone and the dict is returned."""
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.standard_normal(VOL + (4,), dtype=np.float32))
    grids = {k: torch.from_numpy(rng.standard_normal(VOL, dtype=np.float32))
             for k in ("emission", "absorption", "gradient_x", "gradient_z")}
    before = {k: v.clone() for k, v in grids.items()}
    ids = {k: id(v) for k, v in grids.items()}
    out = unpack_accumulator(acc, grids)
    assert out is grids
    for c, key in enumerate(PACK_KEYS):
        want = acc[..., c].clone() if key not in before else before[key] + acc[..., c]
        assert torch.equal(grids[key], want), key
        assert grids[key].is_contiguous() and grids[key].shape == VOL
    assert torch.equal(grids["absorption"], before["absorption"])
    assert all(id(grids[k]) == i for k, i in ids.items())  # in place
    fresh = unpack_accumulator(acc)
    assert list(fresh) == list(PACK_KEYS)
    assert all(torch.equal(fresh[k], acc[..., c]) for c, k in enumerate(PACK_KEYS))
    # a float2 accumulator holds absorption's and reflection's
    pair = torch.from_numpy(rng.standard_normal(VOL + (2,), dtype=np.float32))
    unpack_accumulator(pair, grids)
    assert torch.equal(grids["absorption"], before["absorption"] + pair[..., 0])
    assert torch.equal(grids["reflection"], pair[..., 1]) and grids["reflection"].is_contiguous()


@pytest.mark.parametrize("name", ["packed_absorption_aliased",
                                  "packed_reflection_aliased_two_lights", "packed_both_own"])
def test_shared_accumulator_of_the_bands_unpacks_to_the_whole_replay(name):
    """Bands of image rows that add their cotangents into one float4
    accumulator (and, absorption and reflection of emission's shape, one
    float2), as K6L's bands of one device do, unpacked once into the zeroed
    grids that the bands' other roles scatter into, give the whole image's
    replay within 1e-6 of scale; and that replay is the JAX package's
    within its lit tolerance."""
    jscene, tscene = scenes(name)
    opts = tscene.options(W, H)
    g = cotangent()
    image = cuda_march.render_forward_fast(tscene, opts)
    want = replay_backward(tscene, opts, torch.from_numpy(g), image, angle_floor=True)
    grids = zero_grids(tscene)
    groups = (PACK_KEYS, PAIR_KEYS) if has_pair(tscene) else (PACK_KEYS,)
    assert len(groups) == 1 + (name == "packed_both_own")
    accs = [torch.zeros(VOL + (len(keys),)) for keys in groups]
    for y0, rows in bands(H, 3):
        part = replay_backward(tscene, opts, torch.from_numpy(g[y0:y0 + rows]),
                               image[y0:y0 + rows], y_offset=y0, n_rows=rows, angle_floor=True)
        for acc, keys in zip(accs, groups):  # the kernel's reductions
            acc += cuda_march.interleave([part[k] for k in keys])
        for key in grids:
            if not any(key in keys for keys in groups):
                grids[key] += part[key]
    for acc in accs:
        unpack_accumulator(acc, grids)
    assert list(grids) == list(zero_grids(tscene))
    for key, grid in grids.items():
        assert of_scale(grid, want[key]) <= TOL_BANDS, key

    diff, template = jax_split_scene(jscene)
    jopts = jscene.options(W, H)
    _, vjp = jax.vjp(lambda d: jax_render_fused(jax_merge_scene(template, d), jopts), diff)
    jgrads = vjp(jnp.asarray(g))[0]
    for key in grids:
        assert of_scale(grids[key], np.asarray(jgrads[key])) <= TOL_JAX, key


def test_dp_unpacks_one_set_of_accumulators_a_device(monkeypatch):
    """The rays-DP backward makes one set of accumulators a device where the
    pack exists and unpacks each once, after the last of the device's bands,
    not once a band: three bands on the one CPU device, with accumulators
    stood in for the card's (the CPU's bands add into the grids themselves,
    so they stay zero), one unpack each, and the gradients those of the
    single-device replay within 1e-5 of scale (the tolerance of
    tests/test_torch_lookup_grads.py's routes)."""
    _, tscene = scenes("packed_both_own")
    opts = tscene.options(W, H)
    g = cotangent(2)
    made, unpacked = [], []

    def accumulators(scene):
        made.append(scene.device)
        return [torch.zeros(tuple(scene.emission.data.shape) + (n,)) for n in (4, 2)]

    def unpack(acc, grids):
        unpacked.append((acc.shape[-1], set(grids)))
        return unpack_accumulator(acc, grids)

    monkeypatch.setattr(pallas_dp, "zero_accumulators", accumulators)
    monkeypatch.setattr(pallas_dp, "unpack_accumulator", unpack)
    monkeypatch.setattr(pallas_dp, "lookup_pack", cuda_march.pack_lookup)  # the card's pack
    _, got = pallas_dp.voxel_grads_fast_sharded(tscene, opts, g, mesh=make_mesh(3, "cpu"))
    _, want = voxel_grads_fast(tscene, opts, g)
    assert made == [torch.device("cpu")]
    assert unpacked == [(4, set(zero_grids(tscene))), (2, set(zero_grids(tscene)))]
    assert set(got) == set(want)
    for key in want:
        assert of_scale(got[key], want[key]) <= TOL_ROUTE, key


def test_planner_counts_the_accumulator_where_the_pack_exists():
    """Four grids (or windows of ``rows`` rows) for a lit lookup scene whose
    emission and gradient volumes have one shape, six with absorption and
    reflection separate and of emission's shape, none otherwise; counted
    in the card's training steps (not the CPU's plain route); and the tiers
    of a lit lookup training step keep the order they had without it."""
    _, lookup = scenes("packed_absorption_aliased")
    _, otf = make_scenes(vol_shape=VOL, lighting=True)
    other = lookup.replace(**{k: getattr(lookup, k).replace(
        data=getattr(lookup, k).data[:, ::2, ::2].contiguous()) for k in PACK_KEYS[1:]})
    d, h, w = VOL
    plane = h * w * 4
    assert planner._accumulator_bytes(lookup) == 4 * d * plane
    assert planner._accumulator_bytes(lookup, 12) == 4 * 12 * plane
    assert planner._accumulator_bytes(other) == planner._accumulator_bytes(otf) == 0
    _, both = scenes("packed_both_own")
    assert planner._accumulator_bytes(both) == 6 * d * plane
    opts = lookup.options(W, H)
    tiers = {"cuda": {}, "cuda_dp": {}, "bricked": {"n_devices": 4},
             "slabbed": {"n_slabs": 2}, "streamed": {"n_slabs": 2}}
    rows = {"cuda": d, "cuda_dp": d, "bricked": d // 4 + 2 * HALO,
            "slabbed": d // 2 + 2 * HALO, "streamed": d // 2 + 2 * HALO}
    est = {t: tier_bytes(lookup, opts, t, training=True, **kw) for t, kw in tiers.items()}
    # the ladder's order at a size only planned, grids larger than the rays'
    # state (tests/test_torch_planner.py's PLAN_VOL), with and without it
    _, planned = make_scenes(vol_shape=PLAN_VOL, lighting=True, gradient_volumes=True)
    n = PLAN_VOL[0]
    plan_tiers = {**tiers, "slabbed": {"n_slabs": 8}, "streamed": {"n_slabs": 8}}
    plan_rows = {"cuda": n, "cuda_dp": n, "bricked": n // 4 + 2 * HALO,
                 "slabbed": n // 8 + 2 * HALO, "streamed": n // 8 + 2 * HALO}
    with_acc = {t: tier_bytes(planned, opts, t, training=True, **kw)
                for t, kw in plan_tiers.items()}
    without = {t: with_acc[t] - planner._accumulator_bytes(planned, plan_rows[t])
               for t in plan_tiers}
    assert all(with_acc[t] > without[t] for t in plan_tiers)
    assert sorted(plan_tiers, key=with_acc.get) == sorted(plan_tiers, key=without.get)
    for tier in ("slabbed", "streamed"):
        cpu = tier_bytes(lookup, opts, tier, training=True, device="cpu", **tiers[tier])
        cpu_otf = tier_bytes(otf, opts, tier, training=True, device="cpu", **tiers[tier])
        card = est[tier] - tier_bytes(otf, opts, tier, training=True, **tiers[tier])
        assert card - (cpu - cpu_otf) == 4 * rows[tier] * plane
