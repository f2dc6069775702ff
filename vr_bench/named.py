"""Finds a piece of the benchmark by the name that a configuration or a
traffic mix gives it: ``module("loops", "orbit")`` is ``loops/orbit.py``.
A new piece is a new file in its folder; no file lists the pieces."""

from __future__ import annotations

import importlib
import importlib.util
import os
import re
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")


def module(folder: str, name: str, here: str = HERE) -> ModuleType:
    """``<here>/<folder>/<name>.py``, imported (``here``: the benchmark's
    folder)."""
    path = os.path.join(here, folder, f"{name}.py")
    if not isinstance(name, str) or not _NAME.match(name) or not os.path.exists(path):
        raise ValueError(f"no piece {name!r} in vr_bench/{folder}/")
    full = f"vr_bench.{folder}.{name}"
    if os.path.samefile(here, HERE):
        return importlib.import_module(full)
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
