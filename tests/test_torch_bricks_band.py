"""The K7 launch forms over a band of image rows (``ops/cuda_bricks.py``
with ``y_offset=``, ``n_rows=``) on CPU bricks, where each wrapper runs its
plain pass of ``ops/brick_march.py`` on the same band.

A band's rays are the whole launch's (``make_ray`` from ``row0 + py``), so
phase 1's opacity and entry record and phase 2's contribution and exit
opacity over a band equal the whole launch's rows bit for bit, and the
gradient segment's bands, summed, are the whole segment's gradients to the
order of the sums (1e-5 of scale). A record is keyed with its band, and a
pass refuses a record made for another. ``parallel.bricks._forward`` with a
band (what a rank of a rows x bricks mesh runs) equals the whole fast
forward's rows, and the bands joined are the JAX package's rows x bricks
render (``ray_axis="rays"`` on a 2 x 4 mesh of the 8 virtual CPU devices).

Scenes are 16^3 (``make_scenes``), 24 x 20 images, 4 bricks; the bands are
uneven (rows 0-6 and 7-19) so that no band is a block's multiple.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from volume_renderer_tpu.parallel.bricks import render_forward_bricked as jax_bricked

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

torch.set_num_threads(1)

VOL = (16, 16, 16)
W, H = 24, 20
BRICKS = 4
BANDS = ((0, 7), (7, 13))   # (first row, rows)
GRAD_TOL = 1e-5             # of scale: a band's sums are the whole launch's, in another order

CASES = {
    "unlit": dict(),
    "lit_otf": dict(lighting=True, rotate=(125.0, 25.0, 0.0)),
    "lit_lookup": dict(lighting=True, gradient_volumes=True),
    "dz_negative_aliased": dict(rotate=(180.0, 20.0, 0.0), alias_absorption=True),
    "grazing_mixed": dict(rotate=(88.0, 0.0, 0.0)),
}
GRADIENT_CASES = [c for c in CASES if c != "lit_lookup"]


@functools.lru_cache(maxsize=None)
def whole(case):
    """(split, options, the fast bricked forward of the whole image, a
    cotangent and its up dots) of a case."""
    _, scene = make_scenes(vol_shape=VOL, **CASES[case])
    opts = scene.options(W, H)
    split = bricks.split_bricks(scene, make_mesh(BRICKS, "cpu"))
    fwd = bricks._forward(split, opts, 0.0, fast=True)
    g = torch.from_numpy((np.random.RandomState(5).randn(H, W, 3) * 1e-3).astype(np.float32))
    up = bricks._upstream([brick_march.own_dot(g, own) for own in fwd.own], fwd.ascending,
                          torch.cumsum, 0.0)
    return split, opts, fwd, g, up


def band(t, y0, rows):
    return t[y0:y0 + rows].contiguous()


@pytest.mark.parametrize("case", list(CASES))
def test_phase_1_over_a_band_is_the_whole_launchs_rows(case):
    split, opts, fwd, _, _ = whole(case)
    for brick, entry in zip(split.bricks, fwd.entry):
        w_whole, _ = cuda_bricks.brick_transmittance(brick, opts)
        for y0, rows in BANDS:
            steps = torch.zeros((rows, W), dtype=torch.int32)
            w, got = cuda_bricks.brick_transmittance(brick, opts, steps=steps, y_offset=y0,
                                                     n_rows=rows)
            want = entry.rows(y0, rows)
            assert w.shape == (rows, W) and got.step.shape == (rows, W)
            torch.testing.assert_close(w, band(w_whole, y0, rows), rtol=0, atol=0)
            torch.testing.assert_close(got.step, want.step, rtol=0, atol=0)
            torch.testing.assert_close(got.state, want.state, rtol=0, atol=0)
            assert got.made_for == want.made_for
            assert got.made_for.first_row == y0 and got.made_for.rows == rows
    assert any(bool((e.step >= 0).any()) for e in fwd.entry), case


@pytest.mark.parametrize("case", list(CASES))
def test_phase_2_over_a_band_is_the_whole_launchs_rows(case):
    split, opts, fwd, _, _ = whole(case)
    nonzero = 0.0
    for brick, w_in, entry in zip(split.bricks, fwd.w_in, fwd.entry):
        own, w_out = cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry)
        for y0, rows in BANDS:
            _, band_entry = cuda_bricks.brick_transmittance(brick, opts, y_offset=y0,
                                                            n_rows=rows)
            got, got_out = cuda_bricks.brick_segment(brick, opts, 0.0, band(w_in, y0, rows),
                                                     band_entry, y_offset=y0, n_rows=rows)
            assert got.shape == (rows, W, 3)
            torch.testing.assert_close(got, band(own, y0, rows), rtol=0, atol=0)
            torch.testing.assert_close(got_out, band(w_out, y0, rows), rtol=0, atol=0)
            nonzero = max(nonzero, float(got.abs().max()))
    assert nonzero > 0.0, case


@pytest.mark.parametrize("case", GRADIENT_CASES)
def test_gradient_segment_bands_sum_to_the_whole_segment(case):
    split, opts, fwd, g, up = whole(case)
    for brick, w_in, u, entry in zip(split.bricks, fwd.w_in, up, fwd.entry):
        want = cuda_bricks.brick_gradients(brick, opts, 0.0, g, fwd.image, w_in, u, entry)
        total = {}
        for y0, rows in BANDS:
            _, band_entry = cuda_bricks.brick_transmittance(brick, opts, y_offset=y0,
                                                            n_rows=rows)
            got = cuda_bricks.brick_gradients(
                brick, opts, 0.0, band(g, y0, rows), band(fwd.image, y0, rows),
                band(w_in, y0, rows), band(u, y0, rows), band_entry, y_offset=y0, n_rows=rows)
            assert set(got) == set(want)
            for key, value in got.items():
                assert value.shape == want[key].shape, key
                total[key] = value if key not in total else total[key] + value
        for key, value in want.items():
            scale = max(float(value.abs().max()), 1e-30)
            err = float((total[key].double() - value.double()).abs().max()) / scale
            assert err <= GRAD_TOL, f"{case} brick {brick.index} {key}: {err:.3e} of scale"


@pytest.mark.parametrize("case", ["unlit", "lit_otf"])
def test_the_fast_forward_of_a_band_is_the_whole_forwards_rows(case):
    """``bricks._forward(fast=True)`` over a band, as a rank of a rows x
    bricks mesh runs it, and the gradients of the band's rows."""
    split, opts, fwd, g, _ = whole(case)
    grads = {}
    for y0, rows in BANDS:
        got = bricks._forward(split, opts, 0.0, fast=True, y_offset=y0, n_rows=rows)
        torch.testing.assert_close(got.image, band(fwd.image, y0, rows), rtol=0, atol=0)
        assert got.band == dict(y_offset=y0, n_rows=rows)
        band_grads = bricks._voxel_grads(split, opts, band(g, y0, rows), 0.0, got)
        for key, value in band_grads.items():
            value = bricks.assemble(value) if isinstance(value, list) else value
            grads[key] = value if key not in grads else grads[key] + value
    want = bricks._voxel_grads(split, opts, g, 0.0, fwd)
    for key, value in want.items():
        value = bricks.assemble(value) if isinstance(value, list) else value
        err = float((grads[key] - value).abs().max()) / max(float(value.abs().max()), 1e-30)
        assert err <= GRAD_TOL, f"{case} {key}: {err:.3e} of scale"


def test_bands_joined_match_the_jax_rows_x_bricks_render():
    """The two bands of the fast bricked forward, joined, against the JAX
    package's render_forward_bricked on a 2 x 4 rows x bricks mesh, at the
    tolerance of tests/test_torch_dp.py; and against the port's plain 2 x 4
    render, bit for bit (two even bands of 10 rows)."""
    jscene, tscene = make_scenes(vol_shape=VOL, **CASES["lit_otf"])
    opts = tscene.options(W, H)
    split = bricks.split_bricks(tscene, make_mesh(BRICKS, "cpu"))
    rows = H // 2
    got = torch.cat([bricks._forward(split, opts, 0.0, fast=True, y_offset=r * rows,
                                     n_rows=rows).image for r in range(2)])
    devices = np.array(jax.devices()[:8]).reshape(2, BRICKS)
    jimg = jax_bricked(jscene, jscene.options(W, H), mesh=Mesh(devices, ("rays", "bricks")),
                       ray_axis="rays")
    np.testing.assert_allclose(got.numpy(), np.asarray(jimg), atol=5e-6, rtol=5e-5)
    plain = bricks.render_forward_bricked(tscene, opts, mesh=make_mesh_2d(2, BRICKS, "cpu"))
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert float(got.max()) > 0.0


def test_a_record_is_refused_for_another_band():
    split, opts, fwd, g, up = whole("unlit")
    brick, w_in, entry = split.bricks[1], fwd.w_in[1], fwd.entry[1]
    (y0, rows), (y1, rows1) = BANDS
    _, band_entry = cuda_bricks.brick_transmittance(brick, opts, y_offset=y0, n_rows=rows)
    with pytest.raises(ValueError, match=r"rows 7 \(not 20\)"):
        cuda_bricks.brick_segment(brick, opts, 0.0, w_in, band_entry)
    with pytest.raises(ValueError, match="another march"):
        cuda_bricks.brick_segment(brick, opts, 0.0, band(w_in, y1, rows1), band_entry,
                                  y_offset=y1, n_rows=rows1)
    with pytest.raises(ValueError, match="another march"):
        cuda_bricks.brick_segment(brick, opts, 0.0, band(w_in, y0, rows), entry,
                                  y_offset=y0, n_rows=rows)
    with pytest.raises(ValueError, match="another march"):
        cuda_bricks.brick_gradients(brick, opts, 0.0, band(g, y1, rows1),
                                    band(fwd.image, y1, rows1), band(w_in, y1, rows1),
                                    band(up[1], y1, rows1), band_entry, y_offset=y1,
                                    n_rows=rows1)
    # a record cut from the whole one (Entry.rows) is the band's own
    cuda_bricks.brick_segment(brick, opts, 0.0, band(w_in, y1, rows1), entry.rows(y1, rows1),
                              y_offset=y1, n_rows=rows1)


def test_a_band_outside_the_image_is_refused():
    split, opts, _, _, _ = whole("unlit")
    for y0, rows in ((-1, 4), (H - 3, 4), (0, H + 1)):
        with pytest.raises(ValueError, match="not inside the image"):
            cuda_bricks.brick_transmittance(split.bricks[0], opts, y_offset=y0, n_rows=rows)
    w, entry = cuda_bricks.brick_transmittance(split.bricks[0], opts, y_offset=H - 3)
    assert w.shape == (3, W) and entry.made_for.rows == 3
