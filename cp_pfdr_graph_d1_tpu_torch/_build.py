"""Builds the port's native libraries at first use, into ``build/``.

Two kinds of library are built, both from sources in this repository:

* the CUDA kernels of ``csrc/`` — each source compiled by its own ``nvcc``
  process for ``sm_90a``, all at once, then linked into one shared library
  with a plain C interface, loaded with :mod:`ctypes`;
* the host C++ of ``csrc/host/`` (push-relabel min-cut, native PFDR) —
  compiled the same way by ``g++``.

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
HOST_SRC_DIR = CSRC_DIR / "host"

CUDA_ARCH = "sm_90a"

# name -> loaded library; name -> (seconds, compiler output) of a build
# made by this process
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, tuple[float, str]] = {}


def _stale(so: Path, sources) -> bool:
    return (not so.exists()
            or any(so.stat().st_mtime < s.stat().st_mtime for s in sources))


def _run(cmds):
    """Runs the commands concurrently; returns their combined output, or
    raises with the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"build step failed:\n{' '.join(c)}\n{out}")
    return "".join(outs)


def _build(name: str, sources, cmd, headers=()) -> Path:
    """Builds ``lib{name}.so`` from ``sources`` with the compiler command
    ``cmd`` when it is stale: every source to an object file, one compiler
    process each, all at once, then one link."""
    so = BUILD_DIR / f"lib{name}.so"
    for s in list(sources) + list(headers):
        if not s.exists():
            raise FileNotFoundError(f"source of {so.name} not found: {s}")
    if _stale(so, list(sources) + list(headers)):
        BUILD_DIR.mkdir(exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        tmp = BUILD_DIR / f".{so.name}.{tag}"
        objs = [BUILD_DIR / f".{name}.{i}.{s.stem}.{tag}.o"
                for i, s in enumerate(sources)]
        t0 = time.monotonic()
        try:
            log = _run([cmd + ["-c", "-o", str(o), str(s)]
                        for s, o in zip(sources, objs)])
            log += _run([cmd + ["-shared", "-o", str(tmp)]
                         + [str(o) for o in objs]])
        except RuntimeError:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        os.replace(tmp, so)
        build_log[name] = (time.monotonic() - t0, log)
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
           "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           f"-I{CSRC_DIR}"]
    return _load("cp_pfdr_kernels", sources, cmd, headers)


def host_library(name: str, source_names) -> ctypes.CDLL:
    """g++ build of host C++ sources of ``csrc/host/``, by file name."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    sources = [HOST_SRC_DIR / s for s in source_names]
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17"]
    return _load(name, sources, cmd)
