"""Builds the port's native libraries at first use, into ``build/``.

Two kinds of library are built, both from sources in this repository:

* the CUDA kernels of ``csrc/`` — compiled by ``nvcc`` for ``sm_90a`` into
  one shared library with a plain C interface, loaded with :mod:`ctypes`;
* the host C++ of the JAX package (push-relabel min-cut, native PFDR) —
  compiled by ``g++`` from their paths in ``cp_pfdr_graph_d1_tpu/``, not
  copied, so the two packages run the same host code.

A library is rebuilt when it is missing or older than one of its sources.
Each build writes to a temporary name and renames it into place, so
processes that build concurrently never load a half-written file.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR / "build"
CSRC_DIR = PKG_DIR / "csrc"
JAX_PKG_DIR = PKG_DIR.parent / "cp_pfdr_graph_d1_tpu"

CUDA_ARCH = "sm_90a"

# name -> loaded library; name -> (seconds, compiler output) of a build
# made by this process
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, tuple[float, str]] = {}


def _stale(so: Path, sources) -> bool:
    return (not so.exists()
            or any(so.stat().st_mtime < s.stat().st_mtime for s in sources))


def _build(name: str, sources, cmd, headers=()) -> Path:
    so = BUILD_DIR / f"lib{name}.so"
    for s in list(sources) + list(headers):
        if not s.exists():
            raise FileNotFoundError(f"source of {so.name} not found: {s}")
    if _stale(so, list(sources) + list(headers)):
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
        t0 = time.monotonic()
        proc = subprocess.run(cmd + ["-o", str(tmp)]
                              + [str(s) for s in sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {so.name} failed:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
        build_log[name] = (time.monotonic() - t0, proc.stdout + proc.stderr)
    return so


def _load(name: str, sources, cmd, headers=()) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_build(name, sources, cmd, headers)))
        _libs[name] = lib
    return lib


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH): the CUDA kernels cannot be built")
    return found


def cuda_kernels() -> ctypes.CDLL:
    """The hand-written Hopper kernels of ``csrc/*.cu`` in one library."""
    lib = _libs.get("cp_pfdr_kernels")
    if lib is not None:  # every launch asks: no file-system calls then
        return lib
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    arch = CUDA_ARCH.removeprefix("sm_")
    cmd = [nvcc_path(), f"-gencode=arch=compute_{arch},code={CUDA_ARCH}",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", f"-I{CSRC_DIR}"]
    return _load("cp_pfdr_kernels", sources, cmd, headers)


def host_library(name: str, relative_sources) -> ctypes.CDLL:
    """g++ build of host C++ sources of the JAX package."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    sources = [JAX_PKG_DIR / s for s in relative_sources]
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
    return _load(name, sources, cmd)
