"""Point-cloud file IO (port of ``or4d_tpu/data/pcd_io.py``).

The reference reads scans with open3d (`o3d.io.read_point_cloud`,
dataset_utils.py:70). The port reads all three PCD v0.7 encodings (ascii,
binary, binary_compressed) through its own host library
(:mod:`or4d_tpu_torch.data.ingest_lib`, ``data/csrc/ingest.cpp``):
:func:`read_pcd` is that library's reader. The numpy and Python reader with
its own LZF codec, :func:`read_pcd_plain` and :func:`lzf_decompress`, is the
plain version the tests hold the library against; no ingest path calls it.

A ``binary_compressed`` body is two little-endian uint32 (the compressed
and the uncompressed size) and then the LZF stream, whose decompressed data
is field-major: every point's x, then every point's y, and so on (PCL's
``PCDWriter::writeBinaryCompressed``), not a sequence of records.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import DEPTH_SCALING
from or4d_tpu_torch.data.ingest_lib import read_pcd  # noqa: F401  (the library's reader)

_NP_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4",
             ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4"}
_LZF_MAX_OFF = 1 << 13  # 13-bit back-reference offset (liblzf)
_LZF_MAX_REF = 264  # 7 + 255 + 2: the longest back reference
_LZF_MAX_LIT = 32  # the longest literal run


def lzf_decompress(data: bytes, out_len: int) -> bytes:
    """liblzf's ``lzf_decompress``: control byte < 32 is a literal run of
    ctrl+1 bytes; otherwise a back reference of length (ctrl >> 5) + 2 (7 in
    the top bits takes one more length byte) at offset ((ctrl & 31) << 8 |
    next byte) + 1 behind the output, which may overlap what it writes.
    Raises IOError on malformed input or a size that is not ``out_len``."""
    out = bytearray(out_len)
    ip, op, n_in = 0, 0, len(data)
    while ip < n_in:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:
            n = ctrl + 1
            if op + n > out_len or ip + n > n_in:
                raise IOError("LZF literal run past the end of the buffer")
            out[op:op + n] = data[ip:ip + n]
            ip += n
        else:
            n = ctrl >> 5
            if n == 7:
                if ip >= n_in:
                    raise IOError("LZF stream ends inside a back reference")
                n += data[ip]
                ip += 1
            if ip >= n_in:
                raise IOError("LZF stream ends inside a back reference")
            ref = op - ((ctrl & 0x1F) << 8) - 1 - data[ip]
            ip += 1
            n += 2
            if ref < 0 or op + n > out_len:
                raise IOError("LZF back reference out of range")
            if op - ref >= n:
                out[op:op + n] = out[ref:ref + n]
            else:  # overlapping: the bytes [ref, op) repeat
                pat = bytes(out[ref:op])
                out[op:op + n] = (pat * (n // len(pat) + 1))[:n]
        op += n
    if op != out_len:
        raise IOError(f"LZF stream decoded to {op} bytes, header says {out_len}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """A greedy LZF encoder whose output ``lzf_decompress`` (and liblzf)
    reads: the last position of each 3-byte string is remembered, a match
    within 8192 bytes is extended to at most 264 bytes, everything else goes
    out in literal runs of at most 32 bytes."""
    n = len(data)
    out = bytearray()
    lit_start = 0
    last: dict[bytes, int] = {}
    i = 0

    def literals(a: int, b: int) -> None:
        while a < b:
            k = min(_LZF_MAX_LIT, b - a)
            out.append(k - 1)
            out.extend(data[a:a + k])
            a += k

    while i + 2 < n:
        key = data[i:i + 3]
        ref = last.get(key)
        last[key] = i
        if ref is None or i - ref > _LZF_MAX_OFF:
            i += 1
            continue
        length, cap = 3, min(_LZF_MAX_REF, n - i)
        while length < cap and data[ref + length] == data[i + length]:
            length += 1
        literals(lit_start, i)
        off, ln = i - ref - 1, length - 2
        if ln < 7:
            out.append((ln << 5) | (off >> 8))
        else:
            out.append((7 << 5) | (off >> 8))
            out.append(ln - 7)
        out.append(off & 0xFF)
        i += length
        lit_start = i
    literals(lit_start, n)
    return bytes(out)


def _rgb01(packed: np.ndarray) -> np.ndarray:
    """Packed 0x00RRGGBB (as uint32) -> (N, 3) float32 in 0..1, divided in
    float32."""
    packed = np.asarray(packed, np.uint32)
    chans = [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF]
    return np.stack([c.astype(np.float32) / np.float32(255.0) for c in chans], axis=1)


def read_pcd_plain(path: str | Path) -> np.ndarray:
    """Read a PCD v0.7 file (ascii, binary or binary_compressed) ->
    (N, 6) float32 [xyz, rgb in 0..1]; rgb is 0 without a color field. The
    plain version of :func:`read_pcd`, in numpy and Python."""
    path = str(path)
    header: dict[str, list[str]] = {}
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                raise IOError(f"unexpected EOF in header: {path}")
            line = line.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key] = vals
            if key == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]
        cols = [(name, _NP_TYPES[(t, s)]) + (((c,),) if c > 1 else ())
                for name, t, s, c in zip(fields, types, sizes, counts)]
        dtype = np.dtype(cols).newbyteorder("<")
        if mode == "ascii":
            if any(c != 1 for c in counts):
                raise IOError(f"ascii PCD with COUNT > 1 is not supported: {path}")
            rows = np.loadtxt(f, max_rows=n, ndmin=2)
            rec = {name: rows[:, i].astype(dtype[name]) for i, name in enumerate(fields)}
        elif mode == "binary":
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        elif mode == "binary_compressed":
            sizes_hdr = np.frombuffer(f.read(8), "<u4")
            if len(sizes_hdr) != 2:
                raise IOError(f"truncated binary_compressed header: {path}")
            comp, raw = int(sizes_hdr[0]), int(sizes_hdr[1])
            body = f.read(comp)
            if len(body) != comp:
                raise IOError(f"truncated binary_compressed body: {path}")
            data = lzf_decompress(body, raw)
            rec, off = {}, 0
            for name in fields:  # field-major
                ft = dtype[name]
                rec[name] = np.frombuffer(data, dtype=ft, count=n, offset=off)
                off += ft.itemsize * n
            if off != raw:
                raise IOError(f"binary_compressed body holds {raw} bytes, fields need {off}: {path}")
        else:
            raise IOError(f"unknown PCD DATA mode {mode!r}: {path}")

    out = np.zeros((n, 6), np.float32)
    for i, c in enumerate("xyz"):
        out[:, i] = np.asarray(rec[c], np.float32)
    rgb_field = next((c for c in ("rgb", "rgba") if c in fields), None)
    if rgb_field is not None:
        out[:, 3:] = _rgb01(np.asarray(rec[rgb_field], np.float32).view(np.uint32))
    elif all(c in fields for c in "rgb"):
        for i, c in enumerate("rgb"):
            out[:, 3 + i] = np.asarray(rec[c], np.float32) / np.float32(255.0)
    return out


def read_ply(path: str | Path) -> np.ndarray:
    """Read a PLY point cloud -> (N, 6) float32 [xyz, rgb in 0..1].

    The reference loads registered object scans (`object_scans/*/*.ply`)
    through open3d (helpers/object_pose_utils.py:9-26); this covers ascii and
    binary_little_endian vertex elements with x/y/z (+ red/green/blue).
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise IOError(f"not a PLY file: {path}")
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                props.append((name, typ))
            elif line == "end_header":
                break

        type_map = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4", "uint": "u4",
        }
        dtype = np.dtype([(name, "<" + type_map[typ]) for name, typ in props])
        if fmt == "ascii":
            rows = np.loadtxt(f, max_rows=n, ndmin=2)
            rec = np.rec.fromarrays(rows.T, dtype=dtype)
        elif fmt == "binary_little_endian":
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        else:
            raise IOError(f"unsupported PLY format {fmt}: {path}")

    out = np.zeros((n, 6), np.float32)
    for i, c in enumerate("xyz"):
        out[:, i] = np.asarray(rec[c], np.float32)
    names = [p[0] for p in props]
    if all(c in names for c in ("red", "green", "blue")):
        for i, c in enumerate(("red", "green", "blue")):
            v = np.asarray(rec[c], np.float32)
            out[:, 3 + i] = v / 255.0 if v.max(initial=0) > 1.0 else v
    return out


def scale_registered_translation(transformation: np.ndarray) -> np.ndarray:
    """Registered-object scan transforms store translations in depth units;
    scale by DEPTH_SCALING (object_pose_utils.py:9-14)."""
    t = np.asarray(transformation, np.float64).copy()
    t[:3, 3] *= DEPTH_SCALING
    return t


def coord_transform_pose_tool_to_or4d(arr: np.ndarray) -> np.ndarray:
    """Pose-tool frame -> OR-4D frame (helpers/utils.py:37-47)."""
    a = np.atleast_2d(np.asarray(arr, np.float64)).copy()
    a *= 25
    a[:, 2] += 1000
    a[:, 1] *= -1
    a = a[:, [0, 2, 1]]
    return a


def load_registered_object_scan(ply_path: str | Path, transformation: np.ndarray) -> np.ndarray:
    """get_object_poses for one scan (object_pose_utils.py:9-26): load the
    .ply, scale the transform's translation by DEPTH_SCALING, apply it."""
    pts = read_ply(ply_path)
    t = scale_registered_translation(transformation)
    xyz1 = np.concatenate([pts[:, :3], np.ones((len(pts), 1))], axis=1)
    pts = pts.copy()
    pts[:, :3] = (xyz1 @ t.T)[:, :3]
    return pts


def write_pcd(path: str | Path, points: np.ndarray, binary: bool = True, compressed: bool = False) -> None:
    """Write (N, 6) [xyz rgb01] (or (N, 3) xyz) as PCD v0.7 with a
    packed-float rgb field: ``DATA binary`` (default), ``ascii``
    (``binary=False``) or ``binary_compressed`` (``compressed=True``: the
    fields one after another, LZF-compressed)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    rgb = (
        (np.clip(points[:, 3] * 255, 0, 255).astype(np.uint32) << 16)
        | (np.clip(points[:, 4] * 255, 0, 255).astype(np.uint32) << 8)
        | np.clip(points[:, 5] * 255, 0, 255).astype(np.uint32)
    ).view(np.float32) if points.shape[1] >= 6 else None
    mode = "binary_compressed" if compressed else "binary" if binary else "ascii"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS x y z{' rgb' if rgb is not None else ''}\n"
        f"SIZE 4 4 4{' 4' if rgb is not None else ''}\n"
        f"TYPE F F F{' F' if rgb is not None else ''}\n"
        f"COUNT 1 1 1{' 1' if rgb is not None else ''}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {mode}\n"
    )
    cols = [points[:, 0], points[:, 1], points[:, 2]] + ([rgb] if rgb is not None else [])
    body = np.stack(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        if compressed:
            raw = np.ascontiguousarray(body.T).tobytes()  # field-major
            comp = lzf_compress(raw)
            f.write(np.array([len(comp), len(raw)], "<u4").tobytes())
            f.write(comp)
        elif binary:
            f.write(body.tobytes())
        else:
            np.savetxt(f, body, fmt="%.6f")
