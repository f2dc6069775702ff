"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and without a CUDA card its entry points refuse to run unless the CPU is
named."""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import volume_renderer_tpu_torch
from volume_renderer_tpu_torch import (Volume, VolumeRenderer, henyey_greenstein_lut,
                                       render_oracle)
from volume_renderer_tpu_torch.models.camera import Camera
from volume_renderer_tpu_torch.models.lights import LightSource, pack_lights
from volume_renderer_tpu_torch.models.scene import RenderSettings, Scene
from volume_renderer_tpu_torch.examples import example1, example_inverse
from volume_renderer_tpu_torch.ops import _build, cuda_bricks, cuda_grads, cuda_march
from volume_renderer_tpu_torch.parallel import multihost

PKG = Path(volume_renderer_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
# the port's examples: one for each script of the JAX package's examples/
EXAMPLES = sorted(p.stem for p in (REPO / "examples").glob("*.py") if p.stem != "_data")


def test_import_pulls_in_no_jax():
    code = ("import sys, volume_renderer_tpu_torch, volume_renderer_tpu_torch.convert\n"
            "import volume_renderer_tpu_torch.train, volume_renderer_tpu_torch.ops.vjp\n"
            "import volume_renderer_tpu_torch.ops.cuda_grads\n"
            "import volume_renderer_tpu_torch.ops.brick_march\n"
            "import volume_renderer_tpu_torch.ops.cuda_bricks\n"
            "import volume_renderer_tpu_torch.parallel.mesh\n"
            "import volume_renderer_tpu_torch.parallel.bricks\n"
            "import volume_renderer_tpu_torch.ops.oracle, volume_renderer_tpu_torch.utils\n"
            "import volume_renderer_tpu_torch.utils.checkpoint\n"
            "import volume_renderer_tpu_torch.utils.profiling\n"
            "from volume_renderer_tpu_torch.parallel.multihost import (GroupRelay, BrickDemo,\n"
            "    split_brick_rank, render_forward_bricked_ranks, voxel_grads_bricked_ranks,\n"
            "    split_params_bricked_rank, train_step_fast_bricked_ranks,\n"
            "    render_fused_bricked_ranks, run_demo, RankMesh, global_mesh_2d)\n"
            "import volume_renderer_tpu_torch.examples._data\n"
            + "".join(f"import volume_renderer_tpu_torch.examples.{name}\n" for name in EXAMPLES) +
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
            " or m in ('volume_renderer_tpu', 'examples', 'optax')"
            " or m.startswith(('volume_renderer_tpu.', 'examples.', 'optax.')))\n"
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


def test_the_port_imports_nothing_from_examples():
    """The port's examples are its own: a copy of ``examples/_data.py`` and a
    script for each of ``examples/*.py``, none importing the JAX package's."""
    ported = sorted(p.stem for p in (PKG / "examples").glob("*.py") if p.stem != "__init__")
    assert ported == sorted(EXAMPLES + ["_data"]) and len(EXAMPLES) == 9
    pattern = re.compile(r"^\s*(import|from)\s+examples\b", re.M)
    for path in sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.findall(path.read_text()), f"{path} imports examples"


def test_no_default_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.ones((2, 2, 2), np.float32)
    scene = Scene(emission=Volume.create(data, device="cpu"),
                  camera=Camera.create(focal_length=3.0, distance_to_object=6.0, device="cpu"),
                  settings=RenderSettings.create(device="cpu"))
    for call in (lambda: VolumeRenderer(), lambda: Volume.create(data),
                 lambda: Camera.create(), lambda: RenderSettings.create(),
                 lambda: henyey_greenstein_lut(4),
                 lambda: pack_lights([LightSource([0, 0, 0], [1, 1, 1])]),
                 lambda: render_oracle(scene, scene.options(4, 4)),
                 lambda: multihost.initialize("file:///nonexistent/store", 1, 0),
                 lambda: example1.main(["--size", "8"]),
                 lambda: example_inverse.main(["--size", "8", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Volume.create(data, device="cpu").data.device.type == "cpu"
    assert VolumeRenderer(device="cpu").device.type == "cpu"


def test_edited_header_changes_every_library_path(tmp_path, monkeypatch):
    """A library's name hashes its source, the flags and every header under
    csrc/ it could include, so a stale library is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert {p.stem for p in csrc.glob("*.cu")} == set(_build.SOURCES)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share a header"
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before == {name: _build.library_path(name) for name in _build.SOURCES}
    assert len(set(before.values())) == len(before)

    with open(headers[0], "a") as f:
        f.write("\n// edited\n")
    after_header = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(after_header[name] != before[name] for name in _build.SOURCES)

    with open(csrc / "march_bwd.cu", "a") as f:
        f.write("\n// edited\n")
    after_source = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after_source["march_bwd"] != after_header["march_bwd"]
    assert after_source["march_fwd"] == after_header["march_fwd"]


def test_brick_sources_are_built_and_hashed(tmp_path, monkeypatch):
    """The z-brick kernels are sources of the build like the others: an edit
    of one renames its library and no other."""
    assert {"brick_fwd", "brick_bwd"} <= set(_build.SOURCES)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert (csrc / "brick_common.cuh").exists()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    with open(csrc / "brick_fwd.cu", "a") as f:
        f.write("\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after["brick_fwd"] != before["brick_fwd"]
    assert all(after[name] == before[name] for name in _build.SOURCES if name != "brick_fwd")


def struct_fields(source: Path, struct: str):
    """The member names of ``struct`` in a CUDA source, in order."""
    text = re.sub(r"//[^\n]*", "", source.read_text())
    body = re.search(r"struct\s+%s\s*\{(.*?)\n\};" % struct, text, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        first, *rest = decl.split(",")
        for part in [first.split()[-1], *rest]:
            names.append(re.sub(r"\[\d+\]", "", part).strip().lstrip("*"))
    return names


@pytest.mark.parametrize("source,struct,mirror", [
    ("march_common.cuh", "Vol", cuda_march._Vol),
    ("march_common.cuh", "Vol4", cuda_march._Vol4),
    ("march_common.cuh", "MarchArgs", cuda_march._MarchArgs),
    ("march_bwd.cu", "GradArgs", cuda_grads._GradArgs),
    ("brick_common.cuh", "BrickArgs", cuda_bricks._BrickArgs),
    ("brick_bwd.cu", "BrickGradArgs", cuda_bricks._BrickGradArgs),
    ("march_common.cuh", "Vol2", cuda_march._Vol2),
])
def test_ctypes_mirrors_list_the_structs_fields(source, struct, mirror):
    """A field added to a kernel's argument struct must appear in its ctypes
    mirror, in the same place; the size check at load time would catch a
    mismatch only on the card."""
    want = struct_fields(_build.CSRC_DIR / source, struct)
    assert len(want) >= 4
    assert [name for name, _ in mirror._fields_] == want


def test_corner_carry_has_one_copy():
    """The cell of a sample, its fetch and the corner carry are defined once,
    in corner_carry.cuh, which the two carried scatters reach, K3
    (march_bwd.cu, through lit_replay.cuh) and the K7 gradient segment
    (brick_bwd.cu, through brick_common.cuh), and K5 (march_fwd.cu) and K2
    (march_bwd.cu), which fetch their packed grids at the cell with one blend
    of the corners. The lit step's pieces are defined once too: the tap fetch
    and the shading in march_common.cuh, which K4, K5 and lit phase 2
    (brick_fwd.cu) reach, the sample's replay and its adjoint in
    lit_replay.cuh, which K6, lit K2 and the lit gradient segment
    (brick_bwd.cu) reach."""
    pattern = re.compile(r"^(?:template <[^>]*>\s*)?struct (CornerCarry|Cell|ZSlab)\b|"
                         r"^__device__ __forceinline__ [\w&]+ (cell_of|fetch_cell|fetch_cell_pair|"
                         r"corner_weights|slab_row|blend_cell|load_corners|fetch_packed2?)\(",
                         re.M)
    found = {}
    for path in sorted(_build.CSRC_DIR.glob("*.cu*")):
        for m in pattern.finditer(path.read_text()):
            found.setdefault(m.group(1) or m.group(2), []).append(path.name)
    assert found == {name: ["corner_carry.cuh"] for name in (
        "CornerCarry", "Cell", "ZSlab", "cell_of", "fetch_cell", "fetch_cell_pair",
        "corner_weights", "slab_row", "blend_cell", "load_corners", "fetch_packed",
        "fetch_packed2")}

    def includes(name):
        return re.findall(r'#include "(\w+\.cuh)"', (_build.CSRC_DIR / name).read_text())

    def reaches(name):
        seen, todo = set(), includes(name)
        while todo:
            header = todo.pop()
            if header not in seen:
                seen.add(header)
                todo += includes(header)
        return seen

    assert includes("march_bwd.cu") == ["lit_replay.cuh"]
    assert includes("march_fwd.cu") == ["corner_carry.cuh"]
    assert includes("brick_fwd.cu") == ["brick_common.cuh"]
    assert includes("brick_bwd.cu") == ["brick_common.cuh", "lit_replay.cuh"]
    assert includes("brick_common.cuh") == includes("lit_replay.cuh") == ["corner_carry.cuh"]
    for source in ("march_fwd.cu", "march_bwd.cu", "brick_fwd.cu", "brick_bwd.cu"):
        assert {"corner_carry.cuh", "march_common.cuh"} <= reaches(source)
    assert "lit_replay.cuh" in reaches("march_bwd.cu") & reaches("brick_bwd.cu")

    lit = re.compile(r"^(?:template <[^>]*>\s*)?__device__ __forceinline__ [\w&]+ "
                     r"(tap_geom|fetch_em_taps|shade|scatter_em_taps|angle_bwd|"
                     r"lit_replay_sample)\(", re.M)
    found = {}
    for path in sorted(_build.CSRC_DIR.glob("*.cu*")):
        for m in lit.finditer(path.read_text()):
            found.setdefault(m.group(1), []).append(path.name)
    assert found == {"tap_geom": ["march_common.cuh"], "fetch_em_taps": ["march_common.cuh"],
                     "shade": ["march_common.cuh"], "scatter_em_taps": ["lit_replay.cuh"],
                     "angle_bwd": ["lit_replay.cuh"], "lit_replay_sample": ["lit_replay.cuh"]}
