"""The benchmark's own inputs against the examples' numpy generator and
numpy's gradient."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from vr_bench import inputs
from vr_bench.data import synthetic_zebrafish
from vr_bench.volumes import downsampled, henyey_greenstein, matlab_gradients

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _examples_data():
    spec = importlib.util.spec_from_file_location(
        "examples_data", os.path.join(ROOT, "examples", "_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [24, 40])
def test_zebrafish_equals_the_numpy_generator(n):
    main, _, element_size = _examples_data().synthetic_zebrafish(n, seed=0)
    got = synthetic_zebrafish.zebrafish(n, 0, "cpu", chunk=7).numpy()
    assert got.shape == main.shape == (n // 2, 3 * n // 4, n)
    np.testing.assert_allclose(got, main, rtol=0, atol=2e-6)
    assert element_size == (1.0, 1.0, 2.0)


def test_gradients_equal_numpy_with_matlab_pairing():
    vol = torch.rand(5, 6, 7, generator=torch.Generator().manual_seed(1))
    gy, gx, gz = np.gradient(vol.numpy().astype(np.float64), axis=(1, 2, 0))
    got = matlab_gradients.matlab_gradients(vol)
    for g, want in zip(got, (gy, gx, gz)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-6)


def test_half_resolution_and_normalisation():
    vol = torch.arange(64, dtype=torch.float32).reshape(4, 4, 4)
    half = downsampled.downsample(vol, 2)
    assert half.shape == (2, 2, 2)
    assert float(half[0, 0, 0]) == pytest.approx(float(vol[:2, :2, :2].mean()))
    norm = downsampled.normalized(half, 0.0, 1.0)
    assert float(norm.min()) == 0.0 and float(norm.max()) == 1.0


def test_hg_lut_formula():
    lut = henyey_greenstein.hg_lut(8, 0.8, "cpu")
    c, a, b = 3, 5, 2
    g, al, be = (v * math.pi / 8 for v in (c, a, b))
    cos_t = math.sin(al) * math.sin(be) + math.cos(g) * math.cos(al) * math.cos(be)
    want = (1 - 0.64) / (4 * math.pi * (1 + 0.64 - 1.6 * cos_t) ** 1.5)
    assert float(lut[c, a, b]) == pytest.approx(want, rel=1e-6)


def test_fit_starts_are_the_seeds():
    em, ab = torch.rand(4, 4, 4), torch.rand(2, 2, 2)
    inp = inputs.Inputs(emission=em, absorption=ab, reflection=None, gradients=None,
                        illumination=None, light_positions=None, light_colors=None)
    start = {"emission": {"noise": 0.05, "scale": 1.3, "shift": 0.05},
             "absorption": {"noise": 0.05, "scale": 0.8, "shift": 0.0}}
    a = inputs.fit_starts(inp, start, 2 ** 33 + 5)
    assert list(a) == ["emission", "absorption"]
    for k in a:
        assert torch.equal(a[k], inputs.fit_starts(inp, start, 2 ** 33 + 5)[k])
        assert not torch.equal(a[k], inputs.fit_starts(inp, start, 6)[k])
    assert torch.equal(inputs.fit_starts(inp, start, -1)["absorption"],
                       inputs.fit_starts(inp, start, 2 ** 64 - 1)["absorption"])
    ratio = (a["emission"] - 0.05) / 1.3 / em
    assert float(ratio.min()) >= 0.975 - 1e-6 and float(ratio.max()) <= 1.025 + 1e-6
    ratio = a["absorption"] / 0.8 / ab
    assert float(ratio.min()) >= 0.975 - 1e-6 and float(ratio.max()) <= 1.025 + 1e-6
    # the emission-only start draws the same numbers for emission
    alone = inputs.fit_starts(inp, {"emission": start["emission"]}, 2 ** 33 + 5)
    assert torch.equal(alone["emission"], a["emission"])


def test_every_kind_a_configuration_names_is_a_module():
    import json
    for name in ("vibez-otf", "vibez-lookup"):
        cfg = json.loads(open(os.path.join(ROOT, "vr_bench", "configs", name + ".json")).read())
        inp = inputs.make_inputs(cfg, "cpu", n=8)
        assert inp.emission.shape == (4, 6, 8) and inp.absorption.shape == (2, 3, 4)
        assert inp.reflection.shape == (1, 1, 1) and inp.illumination.shape == (64, 64, 64)
        assert (inp.gradients is None) == (cfg["gradient_volumes"] is None)
    with pytest.raises(ValueError, match="no piece 'nowhere' in vr_bench/data/"):
        inputs.make_inputs({**cfg, "data": {"generator": "nowhere"}}, "cpu", n=8)
