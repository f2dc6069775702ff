"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface under ``build/kernels/`` at the repository root.
The file name carries a hash of the source, of every header under ``csrc/``
that it could include (``*.cuh``) and of the flags, so an edited source or
header is rebuilt and a stale library is never loaded. Nothing is built or
imported when this module is imported: the CPU tests import every module,
and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

# every kernel source of the port
SOURCES = ("march_fwd", "march_bwd", "brick_fwd", "brick_bwd")

# -fmad=false: no contraction of a*b + c into one fused multiply-add, so
# the kernel rounds where its plain version does. Where the normal of a
# nearly flat region rests on the last bits of the taps, contraction alone
# moved lit pixels by up to 1.2e-3 against the plain version (PERF.md).
NVCC_FLAGS = (
    "-O3", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                       "toolkit is installed (CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compiles every named source that has no current library, all at once
    (one ``nvcc`` each, started together). Returns name -> library path;
    ``<library>.log`` holds the compiler's output (registers, spills)."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        path = todo[name]
        Path(str(path) + ".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler's output of the current build of ``name``."""
    return Path(str(library_path(name)) + ".log").read_text()
