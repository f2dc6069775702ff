"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and without a CUDA card its entry points refuse to run unless the CPU is
named."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import volume_renderer_tpu_torch
from volume_renderer_tpu_torch import Volume, VolumeRenderer, henyey_greenstein_lut
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.lights import LightSource, pack_lights
from volume_renderer_tpu_torch.models.scene import RenderSettings

PKG = Path(volume_renderer_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def test_import_pulls_in_no_jax():
    code = ("import sys, volume_renderer_tpu_torch, volume_renderer_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
            " or m == 'volume_renderer_tpu' or m.startswith('volume_renderer_tpu.'))\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|volume_renderer_tpu)\b"
                         r"(?!_torch)", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path} imports {hits}"


def test_no_default_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.ones((2, 2, 2), np.float32)
    for call in (lambda: VolumeRenderer(), lambda: Volume.create(data),
                 lambda: Camera.create(), lambda: RenderSettings.create(),
                 lambda: henyey_greenstein_lut(4),
                 lambda: pack_lights([LightSource([0, 0, 0], [1, 1, 1])])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Volume.create(data, device="cpu").data.device.type == "cpu"
    assert VolumeRenderer(device="cpu").device.type == "cpu"
