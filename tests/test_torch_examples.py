"""The port's examples (``volume_renderer_tpu_torch/examples``) against the
JAX package's scripts (``examples/*.py``), which stay as they are.

Each case runs the JAX script's ``main()`` with ``sys.argv`` set and the
port's ``main([..., "--device", "cpu"])`` with the same flags, at small
sizes; every image either passes to its ``save_image`` is captured before
it is clipped and written, and every ``.npz`` either writes is read back.
Both must write the same files, and each image must agree. The JAX facade
renders on its flat XLA path, as ``tests/test_torch_facade.py`` runs it.
The inverse examples are in ``test_torch_examples_inverse.py``.
"""

from __future__ import annotations

import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import volume_renderer_tpu.api.renderer as jax_renderer_mod
from volume_renderer_tpu.api.planner import RenderPlan as JaxPlan

torch.set_num_threads(1)

# the render_forward tolerance of tests/test_torch_march.py, and that of
# tests/test_torch_facade.py for lit scenes (the normal's direction rests on
# the last bits of the taps, where XLA and torch round differently)
UNLIT_TOL = dict(atol=1e-6, rtol=1e-5)
LIT_TOL = dict(atol=3e-5, rtol=3e-4)

# name: (flags at a small size, tolerance)
FACADE_CASES = {
    "example1": (["--size", "16"], LIT_TOL),
    "example1_grad": (["--size", "16"], LIT_TOL),
    "example2": (["--size", "16", "--frames", "2", "--res", "24", "24"], LIT_TOL),
    "example3": (["--size", "16", "--frames", "2", "--res", "24", "24", "--stereo"], LIT_TOL),
    "example4": (["--size", "16", "--res", "24", "24"], LIT_TOL),
    "paper_illustration_multiple_channels": (["--size", "16"], LIT_TOL),
    "paper_scale_permutations": (["--size", "16", "--step", "10"], LIT_TOL),
}


def run_example(module_name: str, argv, out: Path, monkeypatch, port: bool) -> dict:
    """Runs one example with ``--out`` under ``out``; returns every image it
    saved and every array of every ``.npz`` it wrote, by path under ``out``."""
    mod = importlib.import_module(module_name)
    saved = {}

    def capture(path, img):
        saved[os.path.relpath(path, out)] = np.asarray(img, np.float32).copy()

    monkeypatch.setattr(mod, "save_image", capture)
    name = module_name.rsplit(".", 1)[1]
    argv = list(argv) + ["--out", str(out / name)]
    if port:
        mod.main(argv + ["--device", "cpu"])
    else:
        monkeypatch.setattr(jax_renderer_mod, "plan_render",
                            lambda scene, opts, **kw: JaxPlan("flat"))
        monkeypatch.setattr(sys, "argv", [name] + argv)
        mod.main()
    for path in sorted(out.rglob("*.npz")):
        with np.load(path) as data:
            for key in data.files:
                saved[f"{path.relative_to(out)}:{key}"] = data[key]
    return saved


def run_both(name: str, argv, tmp_path: Path, monkeypatch):
    """(JAX script's outputs, port's outputs) of one example."""
    want = run_example(f"examples.{name}", argv, tmp_path / "jax", monkeypatch, port=False)
    got = run_example(f"volume_renderer_tpu_torch.examples.{name}", argv, tmp_path / "port",
                      monkeypatch, port=True)
    assert sorted(got) == sorted(want)
    assert want, f"{name} saved nothing"
    return want, got


@pytest.mark.parametrize("name", sorted(FACADE_CASES))
def test_facade_example_matches_the_jax_script(name, tmp_path, monkeypatch):
    argv, tol = FACADE_CASES[name]
    want, got = run_both(name, argv, tmp_path, monkeypatch)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], value, err_msg=key, **tol)
    assert any(np.abs(v).max() > 0 for v in got.values())


def test_examples_read_the_jax_scripts_data_directory():
    """A dataset put where the JAX package's examples look for it
    (``examples/h5-data``) is the one the port's examples read too."""
    jax_data = importlib.import_module("examples._data")
    port_data = importlib.import_module("volume_renderer_tpu_torch.examples._data")
    assert os.path.samefile(os.path.dirname(port_data.DATA_DIR),
                            os.path.dirname(jax_data.DATA_DIR))
    assert os.path.abspath(port_data.VIBE_Z) == os.path.abspath(jax_data.VIBE_Z)
