"""The frozen operation counts against chip_smoke.py's on its shell
scenes, the other-shape case by hand, and the sample count against a
plain walk."""

import importlib.util
import os

import pytest
import torch

from vr_bench import roofline
from vr_bench.reference import lit_march as ref
from vr_bench.tests.scenes import small_scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_counts",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("lookup", [False, True])
@pytest.mark.parametrize("n_lights", [1, 2])
def test_counts_equal_chip_smoke_on_its_shell_scenes(lookup, n_lights):
    cs = _chip_smoke()
    mode = "K5" if lookup else "K4"
    # the shell scenes: absorption and reflection separate, of emission's shape
    assert roofline.fwd_flops_per_sample(True, lookup, True, True, True, n_lights) == \
        cs.flops_per_step(mode, False, False, n_lights)
    assert roofline.bwd_flops_per_sample(lookup, True, True, True, n_lights) == \
        cs.bwd_flops_per_step(True, True, False, False, n_lights, lookup=lookup)
    assert roofline.PEAK_FP32_FLOPS == cs.PEAK_FP32_FLOPS
    assert roofline.PEAK_BYTES_PER_S == cs.PEAK_BYTES_PER_S


def test_a_volume_of_another_shape_costs_a_fetch_of_its_own():
    same = roofline.fwd_flops_per_sample(True, False, True, True, True, 2)
    # absorption at half resolution and the 1x1x1 reflection: each a
    # trilinear fetch of 39 (three corners of 6 and 7 lerps of 3) for a
    # blend of 21
    assert roofline.fwd_flops_per_sample(True, False, False, False, True, 2) == same + 2 * 18
    # K5 with gradient volumes of another shape: three fetches for three blends
    k5 = roofline.fwd_flops_per_sample(True, True, True, True, True, 2)
    assert roofline.fwd_flops_per_sample(True, True, True, True, False, 2) == k5 + 3 * 18
    # the backward: 18 more a fetch and the scatter's own weights (3 + 4 + 8)
    bwd = roofline.bwd_flops_per_sample(False, True, True, True, 2)
    assert roofline.bwd_flops_per_sample(False, False, False, True, 2) == bwd + 2 * (18 + 15)


def test_least_time_names_its_bound():
    assert roofline.least_seconds(67e12, 1.0) == {"seconds": 1.0, "bound": "operations"}
    assert roofline.least_seconds(1.0, 3.35e12) == {"seconds": 1.0, "bound": "bytes"}
    assert roofline.share_pct(1.0, 0.0) is None


@pytest.mark.parametrize("factor_absorption", [0.4, 60.0])
def test_sample_count_equals_a_plain_walk(factor_absorption):
    scene = small_scene(16, lookup=False, dtype=torch.float64)
    scene = scene.replace(factor_absorption=torch.tensor(factor_absorption, dtype=torch.float64))
    c = ref.consts(tuple(scene.emission.shape), scene.element_size_um)
    pixels = torch.arange(scene.width * scene.height)
    r = ref.rays(scene, c, pixels, torch.float64)
    total = 0
    bmin = torch.tensor(c.boxmin, dtype=torch.float64)
    scale = 1 / (torch.tensor(c.boxmax, dtype=torch.float64) - bmin)
    for i in range(pixels.numel()):      # one ray at a time, step by step
        opacity, n = 0.0, 0
        while n < int(r.n_geo[i]):
            pos = r.pos0[i] + n * r.step[i]
            ab = float(ref.fetch(scene.absorption, ((pos - bmin) * scale)[None]))
            alpha = 1 - torch.exp(torch.tensor(-factor_absorption * ab * c.tstep)).item()
            opacity = opacity + (1 - opacity) * alpha
            n += 1
            if opacity > scene.opacity_threshold:
                break
        total += n
    got = roofline.count_samples(scene)
    assert got == total
    if factor_absorption > 1:   # the dense case ends rays early
        assert got < int(r.n_geo.sum())
