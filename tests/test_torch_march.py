"""The port's forward march against the JAX package's plain path
(``ops.forward.render_forward``, which the JAX package's own kernel tests
hold its Pallas kernel against), and the kernel wrapper's CPU behaviour."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.forward import render_forward as jax_render_forward

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops import cuda_march
from volume_renderer_tpu_torch.ops.forward import render_forward, render_rows

torch.set_num_threads(1)

W, H = 40, 30

# Same formulas in the same order on both sides; the remaining differences
# are torch's and XLA's float32 exp/acos/rsqrt. Measured max abs error
# 1.3e-7 (lit, reflection aliased) on images of max 0.056.
ATOL, RTOL = 1e-6, 1e-5

CASES = {
    "unlit_aliased": dict(alias_absorption=True),
    "unlit_separate": dict(),
    "lit_otf_1_light": dict(lighting=True),
    "lit_otf_2_lights": dict(lighting=True, n_lights=2, rotate=(200.0, 40.0, -30.0)),
    "lit_otf_reflection_aliased": dict(lighting=True, alias_reflection=True,
                                       alias_absorption=True),
    "lit_lookup": dict(lighting=True, gradient_volumes=True, factors=(1.2, 0.5, 0.7)),
    "non_cubic_scaled": dict(vol_shape=(12, 26, 18), element_size_um=(1.0, 0.8, 1.7),
                             lighting=True),
    # the two scenes chip_smoke.py holds the lit kernels on: y taps 1.33 voxels
    # out (a far axis of the shared tap fetch), z taps 0.56 (near); and a
    # camera near the z axis, whose rays run along faces and edges
    "lit_anisotropic_36x24x64": dict(vol_shape=(36, 24, 64), element_size_um=(1.0, 1.0, 1.6),
                                     lighting=True, rotate=(70.0, 20.0, 5.0)),
    "lit_faces_and_edges_48": dict(vol_shape=(48, 48, 48), lighting=True, rotate=(3.0, 2.0, 0.0)),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("camera_x_offset", [0.0, 0.25])
def test_render_forward_matches_jax(name, camera_x_offset):
    jscene, tscene = make_scenes(**CASES[name])
    want = np.asarray(jax_render_forward(jscene, jscene.options(W, H), camera_x_offset))
    got = render_forward(tscene, tscene.options(W, H), camera_x_offset)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    assert np.count_nonzero(want) > W * H  # the scene is in view
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_opacity_threshold_early_exit_matches_jax():
    jscene, tscene = make_scenes(factors=(1.0, 0.4, 40.0), opacity_threshold=0.5)
    want = np.asarray(jax_render_forward(jscene, jscene.options(W, H)))
    steps = torch.zeros((H, W), dtype=torch.int32)
    got = render_rows(tscene, tscene.options(W, H), 0.0, 0, H, steps=steps)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the threshold cuts rays short of the box
    opts = tscene.options(W, H)
    assert 0 < int(steps.max()) < opts.n_steps - 2


@pytest.mark.parametrize("y_offset,n_rows", [(0, 7), (11, 8), (22, 8)])
def test_render_rows_band_is_slice_of_full_image(y_offset, n_rows):
    _, tscene = make_scenes(lighting=True)
    opts = tscene.options(W, H)
    full = render_forward(tscene, opts, 0.125)
    band = render_rows(tscene, opts, 0.125, y_offset, n_rows)
    np.testing.assert_array_equal(band.numpy(), full[y_offset:y_offset + n_rows].numpy())


@pytest.mark.parametrize("name", ["unlit_separate", "lit_otf_1_light", "lit_lookup"])
def test_render_forward_fast_on_cpu_is_plain_version(name):
    _, tscene = make_scenes(**CASES[name])
    opts = tscene.options(W, H)
    before = cuda_march.LAUNCHES
    steps = torch.zeros((H, W), dtype=torch.int32)
    got = cuda_march.render_forward_fast(tscene, opts, 0.25, steps=steps)
    assert cuda_march.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), render_forward(tscene, opts, 0.25).numpy())
    assert int(steps.sum()) > 0 and int(steps.max()) <= opts.n_steps


def test_kernel_mode():
    assert cuda_march.kernel_mode(make_scenes()[1]) == "K1"
    assert cuda_march.kernel_mode(make_scenes(lighting=True)[1]) == "K4"
    assert cuda_march.kernel_mode(make_scenes(lighting=True, gradient_volumes=True)[1]) == "K5"


def test_render_forward_fast_refuses_other_devices():
    _, tscene = make_scenes()
    meta = tscene.replace(emission=tscene.emission.replace(data=tscene.emission.data.to("meta")))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_march.render_forward_fast(meta, tscene.options(W, H))

