"""The port's inverse-rendering examples against the JAX package's scripts
(the harness of ``test_torch_examples.py``): the images they save and the
loss of every training step.

Under ``tests/conftest.py``'s 8 CPU devices the JAX ``example_inverse``
takes ``train.train_step_sharded`` (8 bands of the 24 rows); on the CPU
the port has one device and takes ``train.train_step``, the same loss of the
whole image. ``example_inverse_lit`` takes ``train_step_fast`` on both sides.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from volume_renderer_tpu import train as jax_train

from test_torch_examples import LIT_TOL, UNLIT_TOL, run_both
from volume_renderer_tpu_torch import train

torch.set_num_threads(1)

ARGV = ["--size", "16", "--res", "24", "--steps", "2"]


def record(monkeypatch, module, name, losses, loss_of):
    step = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = step(*args, **kwargs)
        losses.append((name, float(loss_of(out))))
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("name,jax_step,port_step,tol", [
    ("example_inverse", "train_step_sharded", "train_step", UNLIT_TOL),
    ("example_inverse_lit", "train_step_fast", "train_step_fast", LIT_TOL),
])
def test_inverse_example_matches_the_jax_script(name, jax_step, port_step, tol, tmp_path,
                                                monkeypatch):
    jax_losses, port_losses = [], []
    for step in ("train_step", "train_step_sharded", "train_step_fast"):
        record(monkeypatch, jax_train, step, jax_losses, lambda out: out[2])
        record(monkeypatch, train, step, port_losses, lambda out: out)
    want, got = run_both(name, ARGV, tmp_path, monkeypatch)
    assert [s for s, _ in jax_losses] == [jax_step] * 2
    assert [s for s, _ in port_losses] == [port_step] * 2
    np.testing.assert_allclose([v for _, v in port_losses], [v for _, v in jax_losses],
                               rtol=1e-4, atol=0)
    for key, value in want.items():
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], value, err_msg=key, **tol)
