"""The port's multi-process path (``parallel/multihost.py``) and its scaling
probe (``utils/scaling_probe.py``) on the CPU.

``run_demo(2)`` spawns two processes over gloo (a ``file://`` store in a
temporary directory) that render the lit flagship scene at 12^3 / 16 x 16
rays-DP and take one Adam step of the plain and of the kernel DP step. Every
rank's image, losses and gradients are held against the single-process
paths on the same problem (``render_forward_fast``, ``train.train_step_sharded``
and ``train_step_fast_sharded`` over two bands), and the loss against the
JAX package's single-device ``train.train_step`` on its own flagship scene
(the two packages' scenes differ only in the LUT, which the JAX scene takes
from the port here). ``run_demo`` bounds its own wait: a rank still running
after the timeout is terminated and the test fails instead of hanging.
"""

from __future__ import annotations

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from __graft_entry__ import _flagship_scene as jax_flagship_scene
from volume_renderer_tpu import train as jax_train

from volume_renderer_tpu_torch import train
from volume_renderer_tpu_torch.ops.cuda_march import render_forward_fast
from volume_renderer_tpu_torch.parallel import multihost
from volume_renderer_tpu_torch.parallel.mesh import make_mesh
from volume_renderer_tpu_torch.parallel.pallas_dp import train_step_fast_sharded
from volume_renderer_tpu_torch.utils import scaling_probe
from volume_renderer_tpu_torch.utils.flagship import flagship_scene

torch.set_num_threads(1)

RANKS = 2


@pytest.fixture(scope="module")
def demo():
    return multihost.run_demo(RANKS, device="cpu", timeout=240.0)


def _single_process(step_name):
    """(loss, grads) of one Adam step of the single-process rays-DP step over
    two bands, from the rehearsal's start."""
    scene, opts, target, start = multihost.demo_problem("cpu")
    params = {k: v.detach().clone().requires_grad_(True) for k, v in start.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=multihost.DEMO["lr"])
    step = train.train_step_sharded if step_name == "plain" else train_step_fast_sharded
    loss = step(params, optimizer, scene, opts, target, mesh=make_mesh(RANKS, "cpu"))
    return float(loss), {k: p.grad for k, p in params.items()}, params


def test_every_rank_renders_the_single_process_image(demo):
    scene, opts, _, _ = multihost.demo_problem("cpu")
    want = render_forward_fast(scene, opts)
    assert [r["rank"] for r in demo] == list(range(RANKS))
    for r in demo:
        assert r["backend"] == "gloo" and r["mesh"] == ["cpu"] * RANKS
        # the bands are the whole launch's rays, gathered: bit for bit
        np.testing.assert_array_equal(r["image"].numpy(), want.numpy())


@pytest.mark.parametrize("step_name", ["plain", "fast"])
def test_every_rank_steps_as_the_single_process_step(demo, step_name):
    """``train_step_dp`` against ``train.train_step_sharded`` and
    ``train_step_fast_dp`` against ``train_step_fast_sharded``: the same band
    losses and gradients, summed over two ranks instead of on ``mesh[0]``
    (a sum of two terms in either order). The loss is the image's on both
    sides; the single-process kernel step sums it over the whole image at
    once, the ranks band by band."""
    loss, grads, params = _single_process(step_name)
    for r in demo:
        got = r[step_name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6, atol=0)
        assert set(got["grads"]) == set(grads)
        for key, want in grads.items():
            np.testing.assert_array_equal(got["grads"][key].numpy(), want.numpy(), err_msg=key)
            np.testing.assert_array_equal(got["params"][key].numpy(),
                                          params[key].detach().numpy(), err_msg=key)


def test_rehearsal_loss_matches_jax_single_device_step(demo):
    """The JAX package's single-device ``train.train_step`` from the same
    start: the loss within 1e-5 of it (the replays sum in other orders)."""
    jscene = jax_flagship_scene(multihost.DEMO["volume"], lighting=True)
    port = flagship_scene(multihost.DEMO["volume"], lighting=True, device="cpu")
    jscene = jscene.replace(illumination=jnp.asarray(port.illumination.numpy()))
    opts = jscene.options(multihost.DEMO["width"], multihost.DEMO["height"])
    _, topts, target, _ = multihost.demo_problem("cpu")
    assert (opts.width, opts.height) == (topts.width, topts.height)
    params, static = jax_train.split_params(jscene)
    params = dict(params, emission=params["emission"] * 1.2 + 0.05)
    optimizer = optax.adam(multihost.DEMO["lr"])
    _, _, loss = jax_train.train_step(params, optimizer.init(params), static, opts,
                                      jnp.asarray(target.numpy()), optimizer)
    for r in demo:
        np.testing.assert_allclose(r["plain"]["loss"], float(loss), rtol=1e-5, atol=0)


def test_initialize_reads_the_launcher_environment(monkeypatch):
    """Without arguments ``initialize`` takes its rank and world size from
    torchrun's variables, and refuses a rank outside the group."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "5")
    with pytest.raises(ValueError, match="rank 5 is not in a group of 2"):
        multihost.initialize(device="cpu")


def test_scaling_probe_cpu_run_at_a_tiny_size():
    rec = scaling_probe.measure("cpu", vol=16, img=16, reps=1)
    assert rec["device"] == "cpu" and rec["config"] == "16^3/16^2, lighting off"
    for name in ("rays_dp", "bricked"):
        cell = rec[name]
        assert set(cell) == {"cpu1_s", "cpu8_s", "wall1_s", "wall8_s", "work_efficiency",
                             "overhead_fraction"}
        assert cell["cpu1_s"] > 0 and cell["cpu8_s"] > 0
        assert cell["work_efficiency"] == pytest.approx(cell["cpu1_s"] / cell["cpu8_s"])
    assert rec["work_efficiency"] == rec["bricked"]["work_efficiency"]
