"""``Volume.resize`` against ``jax.image.resize``, and the port's
``utils``: the stopwatch, the phase timer, the profiler trace and the
checkpoints (a round trip with ``torch.optim.Adam``, and parameters saved
by the JAX package)."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volume_renderer_tpu.models.volume import Volume as JVolume
from volume_renderer_tpu.utils import save_checkpoint as jax_save_checkpoint

from test_torch_helpers import make_scenes
from volume_renderer_tpu_torch import Volume, render_forward, train
from volume_renderer_tpu_torch.utils import (
    PhaseTimer,
    Stopwatch,
    load_checkpoint,
    save_checkpoint,
    trace,
)

torch.set_num_threads(1)

METHODS = ["cubic", "linear", "lanczos3", "lanczos5", "nearest"]
SIZES = {
    "half": 0.5,
    "double": 2.0,
    "anisotropic": (7, 20, 9),
    "depth_one": (1, 6, 15),
}


def volume(shape=(6, 10, 12), seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32) * 3.0 - 0.5


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("size", list(SIZES))
def test_resize_matches_jax_image_resize(size, method):
    data = volume()
    want = np.asarray(JVolume.create(data).resize(SIZES[size], method=method).data)
    got = Volume.create(data, device="cpu").resize(SIZES[size], method=method).data
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # the same float32 weights, contracted in another order
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())


def test_resize_aliases_and_rejects_unknown_methods():
    vol = Volume.create(volume(), device="cpu")
    assert torch.equal(vol.resize(0.5, "tricubic").data, vol.resize(0.5).data)
    assert torch.equal(vol.resize(2.0, "trilinear").data, vol.resize(2.0, "linear").data)
    assert torch.equal(vol.resize(1.0).data, vol.data)   # no axis changes
    with pytest.raises(ValueError, match="mitchell"):
        vol.resize(0.5, "mitchellcubic")


def test_stopwatch_counts_and_totals():
    sw = Stopwatch("t")
    sw.add("a", "first")
    for _ in range(3):
        sw.start("a")
        assert sw.stop("a", sync=[torch.ones(2), {"x": torch.zeros(1)}]) >= 0.0
    sw.start("b")
    sw.stop("b")
    assert (sw.count("a"), sw.count("b"), sw.count("c")) == (3, 1, 0)
    assert sw.elapsed("a") > 0.0 and sw.elapsed("c") == 0.0
    report = sw.report()
    assert "[a] first" in report and "over 3 runs" in report and "[b] b" in report
    with pytest.raises(KeyError):
        sw.stop("a")   # not started


def test_phase_timer_counts_and_returns_results():
    pt = PhaseTimer()
    for _ in range(2):
        held = []
        with pt.phase("render", held):
            held.append(torch.ones(3) * 2.0)
    out = pt.timed("sum", torch.sum, torch.ones(4))
    assert float(out) == 4.0
    assert pt.counts == {"render": 2, "sum": 1}
    assert all(t >= 0.0 for t in pt.totals.values())
    assert "render" in pt.report() and "total" in pt.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)) as prof:
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
    assert prof.trace_path is not None and os.path.dirname(prof.trace_path) == str(logdir)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def fit_setup():
    """An unlit scene's parameters, perturbed, Adam over them, and the
    target of the true scene (the training tests' setup at a small size)."""
    _, scene = make_scenes(vol_shape=(12, 10, 8))
    opts = scene.options(16, 12)
    target = render_forward(scene, opts)
    params, static = train.split_params(scene)
    with torch.no_grad():
        params["emission"].mul_(1.3).add_(0.05)
    return params, static, opts, target


def adam(params):
    return torch.optim.Adam(list(params.values()), lr=2e-3)


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    params, static, opts, target = fit_setup()
    optimizer = adam(params)
    for _ in range(3):
        train.train_step(params, optimizer, static, opts, target)
    path = str(tmp_path / "ck" / "state.npz")
    save_checkpoint(path, params, optimizer, 3)
    assert not os.path.exists(path + ".tmp")
    want = float(train.train_step(params, optimizer, static, opts, target))
    after = {k: v.detach().clone() for k, v in params.items()}

    fresh, static2, _, _ = fit_setup()
    fresh_opt = adam(fresh)
    out_params, out_opt, step = load_checkpoint(path, fresh, fresh_opt)
    assert out_params is fresh and out_opt is fresh_opt and step == 3
    got = float(train.train_step(fresh, fresh_opt, static2, opts, target))
    assert got == want
    for key, value in after.items():
        assert torch.equal(fresh[key].detach(), value), key
    with np.load(path) as data:
        assert "params['emission']" in data and "opt['state'][0]['exp_avg']" in data


def test_checkpoint_mismatch_raises_key_error(tmp_path):
    params, _, _, _ = fit_setup()
    path = str(tmp_path / "p.npz")
    save_checkpoint(path, {k: v for k, v in params.items() if k != "color"}, None, 0)
    with pytest.raises(KeyError, match=r"params\['color'\]"):
        load_checkpoint(path, params)
    with pytest.raises(KeyError, match="param_groups"):
        load_checkpoint(path, {k: v for k, v in params.items() if k != "color"}, adam(params))


def test_jax_checkpoint_params_load_into_the_port(tmp_path):
    rng = np.random.default_rng(7)
    arrays = {"emission": rng.random((4, 5, 6)).astype(np.float32),
              "factor_emission": np.float32(1.25), "color": np.array([1.0, 0.5, 0.25], np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    opt = optax.adam(1e-3)
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, jparams, opt.init(jparams), 17)
    params = {k: torch.zeros(np.shape(v), requires_grad=True) for k, v in arrays.items()}
    _, _, step = load_checkpoint(path, params)
    assert step == 17
    for key, value in arrays.items():
        np.testing.assert_array_equal(params[key].detach().numpy(), value)
    with pytest.raises(KeyError, match="optax"):
        load_checkpoint(path, params, torch.optim.Adam(list(params.values())))
