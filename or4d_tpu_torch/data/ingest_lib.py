"""Builds, loads and wraps the port's host ingest library
(``data/csrc/ingest.cpp``): PCD v0.7 reading, LZF decompression, voxel
selection with the reference's voxel-size sweep, and the union crop of a
relation with its mask channel.

The source is compiled at first use with the host compiler (``$CXX``, else
``g++``) into ``build/or4d_tpu_torch_native/`` at the root of the checkout
(listed in ``.gitignore``) and loaded with ``ctypes``. The library's name
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded; each build writes a file of its own
and renames it into place, so processes building at once do not collide.
This build is separate from the CUDA kernels' (``ops/_build.py``): ingest
needs no ``nvcc``, and the kernels need no host library.

The library is host code in every mode, with a card or with
``device="cpu"``. A missing compiler or a failed build raises with the
compiler's output; nothing falls back to the plain versions
(``pcd_io.read_pcd_plain`` and ``lzf_decompress``,
``prep.voxel_downsample_indices``, ``downsample_sweep_plain`` and
``crop_union_plain``), which only the tests and ``chip_smoke.py`` call.
Every result is bit-equal to the plain version's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "or4d_tpu_torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

# the library's negative return codes
_LZF_ERRORS = {-1: "LZF literal run past the end of the buffer", -2: "LZF stream ends inside a back reference",
               -3: "LZF back reference out of range"}
_GRID_ERRORS = {-1: "the cloud has a coordinate that is not finite",
                -2: "the voxel grid's mixed-radix key does not fit in 64 bits"}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "ingest_lzf_decompress": (_P, _I64, _P, _I64),
    "ingest_pcd_points": (_P, _I64, _P, _I64),
    "ingest_pcd_read": (_P, _I64, _P, _I64, _P, _I64),
    "ingest_voxel_select_f32": (_P, _I64, _I64, ctypes.c_double, ctypes.c_int32, _P),
    "ingest_voxel_select_f64": (_P, _I64, _I64, ctypes.c_double, ctypes.c_int32, _P),
    "ingest_voxel_sweep_f32": (_P, _I64, _I64, _I64, _P, ctypes.c_int32, ctypes.c_int32, _P),
    "ingest_voxel_sweep_f64": (_P, _I64, _I64, _I64, _P, ctypes.c_int32, ctypes.c_int32, _P),
    "ingest_crop_union_f32": (_P, _I64, _I64, _P, _P, _P, ctypes.c_int32, ctypes.c_int32, _P, _P),
    "ingest_crop_union_f64": (_P, _I64, _I64, _P, _P, _P, ctypes.c_int32, ctypes.c_int32, _P, _P),
}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"or4d_tpu_torch: the host C++ compiler {cxx!r} was not found ($CXX, else g++); "
                           f"it builds {SOURCE.name}")
    return found


def _lib_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libingest_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; raise on failure."""
    out = _lib_path()
    if out.exists():
        return out
    cxx = _compiler()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE.name} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = _I64
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _rows(points: np.ndarray, dtype=None) -> tuple[np.ndarray, str, int]:
    """``points`` (N, >= 3) as float32 or float64 rows whose first three
    columns are x, y, z, without a copy where its layout allows one: the
    array, its type suffix and its row stride in elements."""
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"expected an (N, >= 3) cloud, got shape {points.shape}")
    dtype = np.dtype(dtype or (points.dtype if points.dtype in (np.float32, np.float64) else np.float64))
    if points.dtype != dtype or points.strides[1] != dtype.itemsize or points.strides[0] % dtype.itemsize:
        points = np.ascontiguousarray(points, dtype)
    return points, "f32" if dtype == np.float32 else "f64", points.strides[0] // dtype.itemsize


def _check_grid(k: int) -> int:
    if k < 0:
        raise ValueError(_GRID_ERRORS[k])
    return k


# ---------------------------------------------------------------------------
# PCD and LZF
# ---------------------------------------------------------------------------

def lzf_decompress(data: bytes, out_len: int) -> bytes:
    """liblzf's ``lzf_decompress`` (``pcd_io.lzf_decompress``'s rules);
    raises IOError on malformed input or a size that is not ``out_len``."""
    out = ctypes.create_string_buffer(max(out_len, 1))
    got = library().ingest_lzf_decompress(data, len(data), out, out_len)
    if got < 0:
        raise IOError(_LZF_ERRORS[got])
    if got != out_len:
        raise IOError(f"LZF stream decoded to {got} bytes, header says {out_len}")
    return out.raw[:out_len]


def read_pcd(path: str | os.PathLike) -> np.ndarray:
    """Read a PCD v0.7 file (ascii, binary or binary_compressed) ->
    (N, 6) float32 [xyz, rgb in 0..1]; rgb is 0 without a color field.
    Raises IOError on a malformed header, body or LZF stream."""
    path = str(path)
    with open(path, "rb") as f:
        data = f.read()
    lib = library()
    err = ctypes.create_string_buffer(512)
    n = lib.ingest_pcd_points(data, len(data), err, len(err))
    if n < 0:
        raise IOError(f"{err.value.decode(errors='replace')}: {path}")
    out = np.empty((n, 6), np.float32)
    if lib.ingest_pcd_read(data, len(data), _ptr(out), n, err, len(err)) != n:
        raise IOError(f"{err.value.decode(errors='replace')}: {path}")
    return out


# ---------------------------------------------------------------------------
# Voxel selection and the sweep
# ---------------------------------------------------------------------------

def voxel_select(xyz: np.ndarray, voxel_size: float, max_per_voxel: int = 8) -> np.ndarray:
    """Indices (int64, ascending) of the up-to-``max_per_voxel``
    lowest-index points in each occupied voxel of size ``voxel_size``:
    ``prep.voxel_downsample_indices``. Raises ValueError on a coordinate that
    is not finite or a grid whose key does not fit in 64 bits."""
    xyz, kind, stride = _rows(xyz)
    if len(xyz) == 0:
        raise ValueError("voxel selection of an empty cloud")
    out = np.empty(len(xyz), np.int64)
    k = getattr(library(), f"ingest_voxel_select_{kind}")(_ptr(xyz), len(xyz), stride, float(voxel_size),
                                                         max_per_voxel, _ptr(out))
    return out[:_check_grid(k)]


def voxel_sweep(points: np.ndarray, target: int, sizes, max_per_voxel: int = 8) -> np.ndarray:
    """The reference's sweep on ``points[:, :3]``: the selection at each
    size in turn until at most ``target`` points remain; the last selection
    above ``target`` (int64, ascending), or every index when the first is
    not above it: ``prep.downsample_sweep_plain``."""
    xyz, kind, stride = _rows(points)
    if len(xyz) == 0:
        raise ValueError("voxel sweep of an empty cloud")
    sz = np.ascontiguousarray(sizes, np.float64)
    out = np.empty(len(xyz), np.int64)
    k = getattr(library(), f"ingest_voxel_sweep_{kind}")(_ptr(xyz), len(xyz), stride, int(target), _ptr(sz),
                                                        len(sz), max_per_voxel, _ptr(out))
    return out[:_check_grid(k)]


# ---------------------------------------------------------------------------
# The union crop
# ---------------------------------------------------------------------------

def crop_union(points: np.ndarray, labels: np.ndarray, mn, mx, sub: int, obj: int) -> tuple[np.ndarray, np.ndarray]:
    """Indices (int64, ascending) of the points strictly inside (mn, mx) on
    all three axes, and their mask channel (float32: 1 where the label is
    ``sub``, 2 where it is ``obj``, else 0), in one pass:
    ``prep.crop_union_plain``. The comparisons are in the type numpy
    promotes the points and the box to."""
    mn, mx = np.asarray(mn), np.asarray(mx)
    dtype = np.result_type(np.asarray(points).dtype, mn.dtype, mx.dtype)
    if dtype not in (np.float32, np.float64):
        dtype = np.float64
    xyz, kind, stride = _rows(points, dtype)
    labels = np.ascontiguousarray(labels, np.int32)
    if labels.shape != (len(xyz),) or mn.shape != (3,) or mx.shape != (3,):
        raise ValueError(f"crop_union: labels {labels.shape}, box {mn.shape} {mx.shape} for {len(xyz)} points")
    if sub == obj:
        raise ValueError("crop_union: the subject's and the object's labels must differ")
    mn, mx = np.ascontiguousarray(mn, dtype), np.ascontiguousarray(mx, dtype)
    idx = np.empty(len(xyz), np.int64)
    mask = np.empty(len(xyz), np.float32)
    k = getattr(library(), f"ingest_crop_union_{kind}")(_ptr(xyz), len(xyz), stride, _ptr(labels), _ptr(mn),
                                                       _ptr(mx), int(sub), int(obj), _ptr(idx), _ptr(mask))
    return idx[:k], mask[:k]
