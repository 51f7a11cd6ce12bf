"""Builds and loads the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, at first use, into
``build/or4d_tpu_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``), and loaded with ``ctypes``. Library names carry a hash of
the source, the ``csrc/*.cuh`` headers it includes and the flags, so an
edited source or header is rebuilt and a stale library is never loaded. All sources are compiled in parallel, one ``nvcc`` each.

A failed build raises with nvcc's output. Nothing here falls back to a plain
version: the wrappers call :func:`library` only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "or4d_tpu_torch_kernels"
SOURCES = ("fps", "fps_cluster", "sa_group_mlp", "ball_query_group", "ball_query_multiscale", "serving_sa1_mlp",
           "ball_query_bounds")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (ptxas register/shared-memory/spill summary) and seconds
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("or4d_tpu_torch: nvcc not found (PATH, then $CUDA_HOME/bin or /usr/local/cuda/bin)")


def _includes(src: bytes) -> list[str]:
    """The ``csrc`` headers a source names in ``#include "..."`` lines."""
    return [m.decode() for m in re.findall(rb'^\s*#\s*include\s*"([^"]+)"', src, flags=re.M)]


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src)
    for header in _includes(src):
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source not yet built, all at once; raise on any failure."""
    nvcc = None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _lib_path(name) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
