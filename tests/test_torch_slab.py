"""The port's z-slab sweep on the CPU against the JAX package's
(``ops/slab.py``): the plain slabbed and streamed renders for rays rising
in z, falling in z and both, early termination, aliased volumes, lit
scenes (on-the-fly and lookup gradients) and one-row slabs; the
``ValueError``s; and the card sweep's geometry (``ops/cuda_slab.py``: the
brick passes over clamped windows, which its wrappers run on the CPU)
against the plain sweep and the single-device march. The gradients and the
training steps are in ``test_torch_slab_grads.py``.

Scenes are 16 x 12 x 10 (``make_scenes``: numpy from a seed), images 16x12
and 24x20. Tolerances: images ``rtol=5e-4, atol=1e-5`` against JAX (the
JAX package's own, ``tests/test_slab.py``); the card sweep's geometry against
the single-device march 1e-7 (both accumulate positions; measured 5e-9).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.slab import render_forward_slabbed as jax_slabbed
from volume_renderer_tpu.ops.slab import render_forward_streamed as jax_streamed

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops import cuda_slab, slab
from volume_renderer_tpu_torch.ops.brick_march import HALO, Slab
from volume_renderer_tpu_torch.ops.cuda_grads import voxel_grads_fast
from volume_renderer_tpu_torch.ops.forward import render_forward
from volume_renderer_tpu_torch.ops.vjp import merge_scene, split_scene

torch.set_num_threads(1)

VOL = (16, 12, 10)
W, H = 16, 12
IMAGE_TOL = dict(rtol=5e-4, atol=1e-5)

# name: (scene arguments, slabs, the share of rays with dz >= 0 it must have)
CASES = {
    "dz_positive": (dict(rotate=(10.0, 5.0, 0.0)), 4, "all"),
    "dz_negative": (dict(rotate=(180.0, 20.0, 0.0)), 4, "none"),
    "dz_mixed": (dict(rotate=(88.0, 0.0, 0.0)), 4, "some"),
    "early_termination": (dict(factors=(3.0, 0.4, 4.0), opacity_threshold=0.3), 4, None),
    "aliased": (dict(lighting=True, alias_absorption=True, alias_reflection=True), 2, None),
    "lit_otf": (dict(lighting=True), 4, None),
    "lit_lookup": (dict(lighting=True, gradient_volumes=True), 4, None),
    "one_row_slabs": (dict(), 16, None),
}


@functools.lru_cache(maxsize=None)
def scenes(name):
    kw, n, _ = CASES[name]
    jscene, tscene = make_scenes(vol_shape=VOL, **kw)
    return jscene, tscene, n


def _ascending_share(tscene, opts) -> float:
    rays = slab._Rays(tscene, opts, 0.0, 0, opts.height)
    return float(((rays.dz() >= 0) & rays.hit).sum() / rays.hit.sum())


@pytest.mark.parametrize("name", list(CASES))
def test_render_forward_slabbed_matches_jax(name):
    jscene, tscene, n = scenes(name)
    opts = tscene.options(W, H)
    share = _ascending_share(tscene, opts)
    want_share = CASES[name][2]
    if want_share == "all":
        assert share == 1.0
    elif want_share == "none":
        assert share == 0.0
    elif want_share == "some":
        assert 0.05 < share < 0.95
    want = np.asarray(jax_slabbed(jscene, jscene.options(W, H), n_slabs=n))
    got = slab.render_forward_slabbed(tscene, opts, n_slabs=n)
    assert got.shape == (H, W, 3) and want.max() > 0
    # both take positions in closed form: measured at most 2e-8
    np.testing.assert_allclose(got.numpy(), want, **IMAGE_TOL)
    # and the sweep is the single-device march (accumulated positions)
    np.testing.assert_allclose(got.numpy(), render_forward(tscene, opts).numpy(), **IMAGE_TOL)


@pytest.mark.parametrize("name", ["dz_positive", "dz_negative", "dz_mixed", "lit_otf",
                                  "one_row_slabs"])
def test_render_forward_streamed_matches_jax(name):
    jscene, tscene, n = scenes(name)
    host = jscene.replace(**{k: getattr(jscene, k).replace(data=np.asarray(getattr(jscene, k).data))
                             for k in ("emission", "absorption", "reflection")
                             if getattr(jscene, k) is not None})
    want = np.asarray(jax_streamed(host, jscene.options(W, H), n_slabs=n))
    got = slab.render_forward_streamed(tscene, tscene.options(W, H), n_slabs=n, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **IMAGE_TOL)
    # one window a role at a time: the streamed render is the slabbed one
    np.testing.assert_array_equal(
        got.numpy(), slab.render_forward_slabbed(tscene, tscene.options(W, H),
                                                 n_slabs=n).numpy())


def test_band_of_rows_and_fixed_trip_count():
    jscene, tscene, n = scenes("early_termination")
    opts = tscene.options(W, H)
    whole = slab.render_forward_slabbed(tscene, opts, n_slabs=n)
    band = slab.render_forward_slabbed(tscene, opts, n_slabs=n, y_offset=3, n_rows=5)
    np.testing.assert_array_equal(band.numpy(), whole[3:8].numpy())
    want = np.asarray(jax_slabbed(jscene, jscene.options(W, H), n_slabs=n, early_exit=False))
    got = slab.render_forward_slabbed(tscene, opts, n_slabs=n, early_exit=False)
    np.testing.assert_allclose(got.numpy(), want, **IMAGE_TOL)


def test_indivisible_and_too_fine_raise():
    _, tscene = make_scenes(vol_shape=(10, 12, 10))
    opts = tscene.options(W, H)
    for call in (slab.render_forward_slabbed, slab.render_fused_slabbed,
                 cuda_slab.render_forward_slabbed_fast):
        with pytest.raises(ValueError, match="divisible"):
            call(tscene, opts, n_slabs=3)
    with pytest.raises(ValueError, match="divisible"):
        slab.render_forward_streamed(tscene, opts, n_slabs=3, device="cpu")
    # d = 10, 5 slabs: 2 rows + 2 x HALO fit; 10 slabs: 1 + 4 fit as well;
    # a 4-row volume in 4 slabs does not (1 + 4 > 4)
    _, thin = make_scenes(vol_shape=(4, 12, 10))
    with pytest.raises(ValueError, match="too fine"):
        slab.render_forward_slabbed(thin, thin.options(W, H), n_slabs=4)
    with pytest.raises(ValueError, match="too fine"):
        slab.streamed_grads(thin, thin.options(W, H), np.zeros((H, W, 3), np.float32),
                            n_slabs=4, device="cpu")


def test_slab_geometry_is_the_clamped_window():
    """A slab's grids are the JAX package's clamped windows, views of the
    whole grids, and ``Slab.slab_geometry`` places them."""
    _, tscene = make_scenes(vol_shape=VOL)
    d = VOL[0]
    for n in (2, 4, 8, 16):
        for s in range(n):
            start, rows = slab._slab_window(d, n, s)
            assert rows == d // n + 2 * HALO and 0 <= start <= d - rows
            part = slab.slab_of(tscene, s, n)
            assert isinstance(part, Slab)
            win = part.scene.emission.data
            assert win.shape[0] == rows and win.data_ptr() == tscene.emission.data[start].data_ptr()
            assert part.slab_geometry(win) == (start, d)
            # the unsampled reflection grid of an unlit scene stays out
            assert part.scene.reflection.data.shape == (1, 1, 1)
            # every row the slab owns, and the trilinear neighbours, lie inside
            own = range(s * (d // n), (s + 1) * (d // n))
            assert start <= max(own[0] - 1, 0) and min(own[-1] + 1, d - 1) < start + rows


@pytest.mark.parametrize("name", ["dz_positive", "dz_negative", "dz_mixed", "early_termination",
                                  "one_row_slabs"])
def test_card_sweep_geometry_matches_the_plain_sweep(name):
    """The card's sweep (the K7 forms, here their plain passes) against the
    plain slab sweep and the single-device march."""
    _, tscene, n = scenes(name)
    opts = tscene.options(W, H)
    got = cuda_slab.render_forward_slabbed_fast(tscene, opts, n_slabs=n)
    np.testing.assert_allclose(got.numpy(), slab.render_forward_slabbed(
        tscene, opts, n_slabs=n).numpy(), **IMAGE_TOL)
    # the brick passes accumulate positions as the single-device march does
    np.testing.assert_allclose(got.numpy(), render_forward(tscene, opts).numpy(),
                               rtol=0, atol=1e-7)
    stats = cuda_slab.LAST_SWEEP
    assert stats.tier == "slabbed" and stats.n_slabs == n and stats.h2d_bytes == 0
    visited = [s for sweep in stats.visited for s in sweep]
    assert 0 < len(visited) <= 2 * n and set(visited) <= set(range(n))
    for sweep in stats.visited:  # each sweep in one order
        assert sweep == sorted(sweep) or sweep == sorted(sweep, reverse=True)


def test_card_sweep_stops_where_the_rays_do():
    """On a dense scene with threshold 0.3 every ray stops before the far
    slabs: the sweep stops after the slab where the last one did."""
    _, tscene = make_scenes(vol_shape=VOL, rotate=(10.0, 5.0, 0.0), factors=(3.0, 0.4, 40.0),
                            opacity_threshold=0.3)
    opts = tscene.options(W, H)
    got = cuda_slab.render_forward_slabbed_fast(tscene, opts, n_slabs=8)
    (visited,) = cuda_slab.LAST_SWEEP.visited
    assert len(visited) < 8, visited
    np.testing.assert_allclose(got.numpy(), render_forward(tscene, opts).numpy(),
                               rtol=0, atol=1e-7)


def test_card_sweep_refuses_lit_scenes():
    """What the card's sweep refuses of a lit scene: since the lit forms of
    the brick kernels and the lookup form of the gradient segment, nothing.
    It renders a scene with lookup gradient volumes, and its backward (the
    gradients of the three gradient volumes among its grids, through
    autograd too) is within 1e-5 of scale of single-device
    ``voxel_grads_fast`` (the other lit sweeps' results are in
    test_torch_lit_routes.py)."""
    _, tscene, n = scenes("lit_lookup")
    opts = tscene.options(W, H)
    np.testing.assert_allclose(
        cuda_slab.render_forward_slabbed_fast(tscene, opts, n_slabs=n).numpy(),
        render_forward(tscene, opts).numpy(), rtol=0, atol=1e-7)
    g = torch.from_numpy((np.random.default_rng(2).standard_normal((H, W, 3)) * 0.1)
                         .astype(np.float32))
    _, want = voxel_grads_fast(tscene, opts, g)
    assert {"gradient_x", "gradient_y", "gradient_z"} <= set(want)
    _, got = cuda_slab.voxel_grads_slabbed_fast(tscene, opts, g, n_slabs=n)
    diff, template = split_scene(tscene)
    leaves = {k: v.clone().requires_grad_(True) for k, v in diff.items()}
    out = cuda_slab.render_fused_slabbed_fast(merge_scene(template, leaves), opts, n_slabs=n)
    (out * g).sum().backward()
    assert set(got) == set(want) and set(leaves) <= set(want)
    for grads in (got, {k: v.grad for k, v in leaves.items()}):
        for key, value in grads.items():
            err = float((value - want[key]).abs().max()) / max(float(want[key].abs().max()),
                                                               1e-30)
            assert err <= 1e-5, f"{key}: {err:.3e} of scale"


def test_streamed_fast_needs_a_card():
    _, tscene, n = scenes("dz_positive")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_slab.render_forward_streamed_fast(tscene, tscene.options(W, H), n_slabs=n,
                                               device="cpu")
