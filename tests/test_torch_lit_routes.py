"""Lit scenes on the card's large-volume routes, on the CPU: the lit forms of
K7 phase 2 and of the gradient segment (``ops/cuda_bricks.py``, whose
wrappers run their plain passes on CPU bricks) through the fast bricked
entry points (``parallel/bricks.py``) and the card's slab sweep
(``ops/cuda_slab.py``), against the JAX package's XLA lit renders
(``parallel.bricks.render_forward_bricked``, ``ops.slab.render_forward_slabbed``,
``render_forward_streamed``); and ``chip_smoke.py``'s reading of the lit
forms. The gradients are in ``test_torch_lit_routes_grads.py``, which takes
its scenes, cases and tolerances from here.

Scenes are 16 x 12 x 10 (``make_scenes``: numpy from a seed), images 16x12,
4 bricks or slabs. Tolerances, as the port's existing tests state them:
images against JAX ``rtol=5e-4, atol=1e-5`` (the JAX package's own for its
slab and bricked renders; the JAX sweep takes positions in closed form, the
card's accumulates them: 1.2e-4 to 6.1e-4 of scale at full size on an H100,
``test_torch_slab.py::test_card_sweep_geometry_matches_the_plain_sweep``);
against the port's single-device march 1e-7 (the same positions and fetches);
gradients against ``voxel_grads_fast`` 1e-5 of each key's scale (the same
replay and angle adjoint; the entry opacity ``1 - prod T`` and the order of
the sums differ); against the JAX package's single-device replay 3e-4 of
scale (``test_torch_bricks_grads.py``'s), and against its ``streamed_grads``
2e-3 of scale: the two sweeps' positions differ as above, and a sample that
one takes and the other does not moves the gradient of its voxels by a share
of it (``chip_smoke.py`` bounds the same drift of the images by 2e-3).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from volume_renderer_tpu.ops.slab import render_forward_slabbed as jax_slabbed
from volume_renderer_tpu.ops.slab import render_forward_streamed as jax_streamed
from volume_renderer_tpu.parallel.bricks import render_forward_bricked as jax_bricked
from volume_renderer_tpu.parallel.sharding import make_mesh as jax_make_mesh

import chip_smoke
from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch.ops import brick_march, cuda_bricks, cuda_march, cuda_slab
from volume_renderer_tpu_torch.ops.forward import render_forward
from volume_renderer_tpu_torch.parallel import bricks
from volume_renderer_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

VOL = (16, 12, 10)
W, H = 16, 12
N = 4  # bricks and slabs
IMAGE_TOL = dict(rtol=5e-4, atol=1e-5)
TOL_JAX_SWEEP_OF_SCALE = 2e-3
TOL_SINGLE = 1e-5
TOL_JAX_OF_SCALE = 3e-4

# The lit scenes: on-the-fly taps under a camera whose samples stay off the
# angle adjoint's poles (test_torch_bricks_grads.py), lookup gradient
# volumes, every role aliased to emission, and rays rising and falling in z.
CASES = {
    "lit_otf": dict(lighting=True, rotate=(125.0, 25.0, 0.0)),
    "lit_lookup": dict(lighting=True, gradient_volumes=True),
    "lit_aliased": dict(lighting=True, alias_absorption=True, alias_reflection=True,
                        rotate=(125.0, 25.0, 0.0)),
    "lit_otf_dz_mixed": dict(lighting=True, rotate=(88.0, 0.0, 0.0)),
}
GRAD_CASES = [name for name, kw in CASES.items() if not kw.get("gradient_volumes")]


@functools.lru_cache(maxsize=None)
def scenes(name):
    return make_scenes(vol_shape=VOL, **CASES[name])


def cotangent(seed=1):
    return (np.random.default_rng(seed).standard_normal((H, W, 3)) * 0.1).astype(np.float32)


def of_scale(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def whole(value) -> torch.Tensor:
    return bricks.assemble(value) if isinstance(value, list) else value


# ---- the forward: lit phase 2 ------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_lit_bricked_fast_matches_jax_bricked(name):
    """``render_forward_bricked_fast`` (phase 1 and lit phase 2 a brick)
    against the JAX package's bricked render, which takes a lit scene in
    XLA, and against the port's single-device march."""
    jscene, tscene = scenes(name)
    opts = tscene.options(W, H)
    want = np.asarray(jax_bricked(jscene, jscene.options(W, H),
                                  mesh=jax_make_mesh(N, axis_name="bricks")))
    before = dict(cuda_march.LAUNCHES_BY_MODE)
    got = bricks.render_forward_bricked_fast(tscene, opts, mesh=make_mesh(N, "cpu"))
    assert cuda_march.LAUNCHES_BY_MODE == before  # on the CPU no kernel launch is counted
    assert got.shape == (H, W, 3) and want.max() > 0
    np.testing.assert_allclose(got.numpy(), want, **IMAGE_TOL)
    np.testing.assert_allclose(got.numpy(), render_forward(tscene, opts).numpy(),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("name", list(CASES))
def test_lit_card_sweep_matches_jax_slabbed_and_streamed(name):
    """The card's slab sweep (phase 1 and lit phase 2 a slab over the clamped
    windows of every lit role) against the JAX package's slabbed and streamed
    renders and the port's single-device march."""
    jscene, tscene = scenes(name)
    opts = tscene.options(W, H)
    got = cuda_slab.render_forward_slabbed_fast(tscene, opts, n_slabs=N).numpy()
    want = np.asarray(jax_slabbed(jscene, jscene.options(W, H), n_slabs=N))
    assert want.max() > 0
    np.testing.assert_allclose(got, want, **IMAGE_TOL)
    host = jscene.replace(**{k: getattr(jscene, k).replace(data=np.asarray(getattr(jscene, k).data))
                             for k in ("emission", "absorption", "reflection", "gradient_x",
                                       "gradient_y", "gradient_z")
                             if getattr(jscene, k) is not None})
    np.testing.assert_allclose(got, np.asarray(jax_streamed(host, jscene.options(W, H),
                                                            n_slabs=N)), **IMAGE_TOL)
    np.testing.assert_allclose(got, render_forward(tscene, opts).numpy(), rtol=0, atol=1e-7)
    stats = cuda_slab.LAST_SWEEP
    assert stats.tier == "slabbed" and 0 < sum(len(v) for v in stats.visited) <= 2 * N


def test_lit_phase_2_samples_the_windows_of_every_lit_role():
    """A lit brick's phase 2 reads reflection and the gradient volumes from
    their windows: doubling a row the brick owns in either changes its
    contribution."""
    _, tscene = scenes("lit_lookup")
    opts = tscene.options(W, H)
    split = bricks.split_bricks(tscene, make_mesh(N, "cpu"))
    brick = split.bricks[1]
    w_in = torch.zeros((H, W))
    _, entry = cuda_bricks.brick_transmittance(brick, opts)
    base, _ = cuda_bricks.brick_segment(brick, opts, 0.0, w_in, entry)
    assert float(base.abs().max()) > 0
    for key in ("reflection", "gradient_x"):
        vol = getattr(brick.scene, key)
        bumped = vol.data.clone()
        bumped[brick_march.HALO + 1] *= 2.0  # an owned row
        moved = brick._replace(scene=brick.scene.replace(**{key: vol.replace(data=bumped)}))
        got, _ = cuda_bricks.brick_segment(moved, opts, 0.0, w_in, entry)
        assert float((got - base).abs().max()) > 0, key


# ---- chip_smoke.py's reading of the lit forms ------------------------------------


def test_ptxas_report_of_the_lit_brick_kernels():
    """chip_smoke's reading of ptxas: the lit forms map to their own modes
    (lit phase 2 with its PACKED argument, the lookup form a mode of its own
    for its blocks), lit phase 2 in 16 x kLitRows
    blocks (16x4) and 16 x kLitLookupRows with lookup (16x8), the lit
    gradient segment in 16x8 (K6's)."""
    log = "\n".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{kernel}I{args}EEv{struct}' "
        "for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {registers} registers, used 0 barriers, 640 bytes cmem[0]"
        for kernel, args, struct, registers in (
            ("20brick_lit_fwd_kernel", "Lb0ELb0ELb1ELb0E", "9BrickArgs", 128),
            ("20brick_lit_fwd_kernel", "Lb1ELb0ELb1ELb1E", "9BrickArgs", 100),
            ("20brick_lit_bwd_kernel", "Lb0ELb0E", "13BrickGradArgs", 168)))
    got = chip_smoke.ptxas_by_kernel(log, threads=chip_smoke.kernel_threads(chip_smoke.REPO))
    assert set(got) == {"K7_segment_lit brick_lit_fwd_kernel<0,0,1,0>",
                        "K7_segment_lit_lookup brick_lit_fwd_kernel<1,0,1,1>",
                        "K7_scatter_lit brick_lit_bwd_kernel<0,0>"}
    otf = got["K7_segment_lit brick_lit_fwd_kernel<0,0,1,0>"]
    lookup = got["K7_segment_lit_lookup brick_lit_fwd_kernel<1,0,1,1>"]
    bwd = got["K7_scatter_lit brick_lit_bwd_kernel<0,0>"]
    assert (otf["threads"], otf["blocks_per_sm"]) == (64, 8)
    assert (lookup["threads"], lookup["blocks_per_sm"]) == (128, 4)
    assert (bwd["threads"], bwd["blocks_per_sm"]) == (128, 3)


@pytest.mark.parametrize("lookup", [False, True])
def test_lit_brick_operation_counts(lookup):
    """The lit forms' operations a sample: lit phase 2 is phase 2's count
    plus the lit terms of K4's (K5's) step; the lit gradient segment is K6's
    step plus the owner, as the unlit segment is K3's plus the owner."""
    mode = "K5" if lookup else "K4"
    for n_lights in (1, 2):
        lit_terms = (chip_smoke.flops_per_step(mode, False, False, n_lights)
                     - chip_smoke.flops_per_step("K1", False, True, 0))
        assert (chip_smoke.brick_flops_per_sample("segment_lit", False, lookup=lookup,
                                                  n_lights=n_lights)
                == chip_smoke.brick_flops_per_sample("segment", False) + lit_terms)
        assert (chip_smoke.brick_flops_per_sample("scatter_lit", False, n_lights=n_lights)
                == chip_smoke.bwd_flops_per_step(True, True, False, False, n_lights) + 5)
    assert (chip_smoke.brick_flops_per_sample("scatter", False)
            == chip_smoke.bwd_flops_per_step(False, True, False, True, 0) + 5)
