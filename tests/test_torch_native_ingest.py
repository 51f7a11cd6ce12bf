"""The port's host ingest library (``or4d_tpu_torch/data/csrc/ingest.cpp``,
bound by ``data/ingest_lib.py``) against the port's plain versions and the
JAX package, bit for bit, on the same numpy inputs from a seed:

* PCD reads of all three encodings (the golden fixture's binary and ascii
  scans; ``write_pcd`` of random clouds with packed rgb; clouds with
  separate r/g/b and extra fields of other types and counts) against
  ``pcd_io.read_pcd_plain`` and ``or4d_tpu.data.pcd_io`` (its native reader
  where ``native_available()``, its numpy reader for the uncompressed ones);
  malformed headers, bodies and LZF streams raise IOError;
* LZF round trips through ``lzf_compress`` and the malformed streams
  (truncated, a back reference before the start, a wrong size), against
  ``pcd_io.lzf_decompress`` and the JAX package's native decoder;
* the voxel selection and the sweep on clouds with duplicate points,
  points exactly on voxel boundaries, fewer points than the target and
  more than 8 points a voxel, in float32 and float64, against
  ``prep.voxel_downsample_indices`` / ``downsample_sweep_plain`` and the JAX
  package's numpy and native ones; ``calculate_downsample_indices`` of both
  packages from one seed; a grid whose key does not fit in 64 bits raises
  ValueError;
* the union crop with points exactly on ``mn`` / ``mx`` against
  ``prep.crop_union_plain``, the JAX package's numpy branch and its native
  crop;
* a build with no compiler, or a compiler that fails, raises.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest

from or4d_tpu.data import pcd_io as jpcd
from or4d_tpu.data import prep as jprep

from or4d_tpu_torch.config import DatasetConfig
from or4d_tpu_torch.data import ingest_lib, pcd_io, prep

ROOT = Path(__file__).parent / "golden" / "real_data"
PCDS = sorted(ROOT.glob("export_holistic_take*_processed/pcds/*.pcd"))
JAX_NATIVE = jpcd.native_available()
DS = DatasetConfig()
TARGETS = (1000, DS.num_points_objects, DS.num_points_relation)


def assert_same(*arrays):
    first = arrays[0]
    for a in arrays[1:]:
        assert a.dtype == first.dtype and a.shape == first.shape, (a.dtype, first.dtype, a.shape, first.shape)
        np.testing.assert_array_equal(a, first)


# --------------------------------------------------------------------------- PCD


@pytest.mark.parametrize("path", PCDS, ids=lambda p: f"take{p.parts[-3][21]}_{p.stem}")
def test_fixture_reads_equal_the_plain_reader_and_jax(path):
    got = pcd_io.read_pcd(path)
    assert_same(got, pcd_io.read_pcd_plain(path), jpcd.read_pcd(path), jpcd._read_pcd_numpy(str(path)))


def _write_fields(path: Path, fields, mode: str) -> None:
    """A PCD with the given ``(name, type, size, count, values)`` fields,
    ``values`` (N, count) in that type."""
    n = len(fields[0][4])
    names, types, sizes, counts = zip(*[(f[0], f[1], str(f[2]), str(f[3])) for f in fields])
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
              f"FIELDS {' '.join(names)}\nSIZE {' '.join(sizes)}\nTYPE {' '.join(types)}\n"
              f"COUNT {' '.join(counts)}\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {mode}\n")
    cols = [np.asarray(f[4]).reshape(n, f[3]).astype(np.dtype(f"<{ {'F': 'f', 'U': 'u', 'I': 'i'}[f[1]]}{f[2]}"))
            for f in fields]
    with open(path, "wb") as fh:
        fh.write(header.encode())
        if mode == "ascii":
            for i in range(n):
                fh.write((" ".join(repr(v.item()) for c in cols for v in c[i]) + "\n").encode())
        elif mode == "binary":
            rec = np.zeros(n, [(f"f{j}", c.dtype, (c.shape[1],)) for j, c in enumerate(cols)])
            for j, c in enumerate(cols):
                rec[f"f{j}"] = c
            fh.write(rec.tobytes())
        else:
            raw = b"".join(np.ascontiguousarray(c).tobytes() for c in cols)  # field-major
            comp = pcd_io.lzf_compress(raw)
            fh.write(np.array([len(comp), len(raw)], "<u4").tobytes() + comp)


@pytest.mark.parametrize("mode", ["ascii", "binary", "binary_compressed"])
def test_written_clouds_read_equal_in_every_encoding(mode, tmp_path):
    rng = np.random.default_rng(7)
    n = 3000
    xyz = rng.uniform(-2000, 2000, (n, 3)).astype(np.float32)
    xyz[::50] = np.round(xyz[::50])  # whole numbers: runs the LZF encoder can back-reference
    rgb01 = rng.integers(0, 256, (n, 3)) / 255.0
    packed = tmp_path / "packed.pcd"
    pcd_io.write_pcd(packed, np.concatenate([xyz, rgb01], 1), binary=mode != "ascii",
                     compressed=mode == "binary_compressed")
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    separate = tmp_path / "separate.pcd"
    _write_fields(separate, [("x", "F", 4, 1, xyz[:, 0]), ("y", "F", 4, 1, xyz[:, 1]),
                             ("intensity", "F", 8, 1 if mode == "ascii" else 2,
                              rng.standard_normal((n, 1 if mode == "ascii" else 2))),
                             ("z", "F", 4, 1, xyz[:, 2]), ("label", "I", 2, 1, rng.integers(-9, 9, n)),
                             ("r", "U", 1, 1, rgb[:, 0]), ("g", "U", 1, 1, rgb[:, 1]), ("b", "U", 1, 1, rgb[:, 2])],
                  mode)
    for path in (packed, separate):
        got = pcd_io.read_pcd(path)
        assert got.shape == (n, 6) and got.dtype == np.float32
        want = [pcd_io.read_pcd_plain(path)] + ([jpcd.read_pcd(path)] if JAX_NATIVE else [])
        if mode == "ascii" or (mode == "binary" and path == packed):  # its numpy reader: COUNT 1 only, no LZF
            want.append(jpcd._read_pcd_numpy(str(path)))
        assert_same(got, *want)
    np.testing.assert_array_equal(pcd_io.read_pcd(separate)[:, 3:], rgb.astype(np.float32) / np.float32(255.0))
    if mode != "ascii":  # ascii writes rgb with 6 decimals: the packed colour is lost
        np.testing.assert_array_equal(pcd_io.read_pcd(packed)[:, :3], xyz)


def _pcd_bytes(tmp_path: Path) -> bytes:
    path = tmp_path / "c.pcd"
    pts = np.random.default_rng(3).uniform(-1, 1, (200, 6)).astype(np.float32)
    pts[:, 3:] = np.abs(pts[:, 3:])
    pcd_io.write_pcd(path, np.repeat(pts, 2, axis=0), compressed=True)
    return path.read_bytes()


def _malformed(data: bytes, case: str) -> bytes:
    head, body = data.split(b"DATA binary_compressed\n")
    head += b"DATA binary_compressed\n"
    comp, raw = np.frombuffer(body[:8], "<u4")
    return {
        "header_eof": head.split(b"DATA")[0],
        "unknown_mode": head.replace(b"binary_compressed", b"binary_lzma") + body,
        "sizes_truncated": head + body[:5],
        "body_truncated": head + body[:-1],
        "lzf_truncated": head + np.array([comp - 1, raw], "<u4").tobytes() + body[8:-1],
        "lzf_size": head + np.array([comp, raw + 4], "<u4").tobytes() + body[8:],
        "lzf_reference_before_start": head + np.array([2, raw], "<u4").tobytes() + b"\x20\x05",
        "fields_size": head.replace(b"POINTS 400", b"POINTS 399") + body,
        "no_points": head.replace(b"POINTS 400\n", b"") + body,
        "binary_truncated": head.replace(b"binary_compressed", b"binary") + body[:100],
    }[case]


@pytest.mark.parametrize("case", ["header_eof", "unknown_mode", "sizes_truncated", "body_truncated", "lzf_truncated",
                                  "lzf_size", "lzf_reference_before_start", "fields_size", "no_points",
                                  "binary_truncated"])
def test_malformed_pcds_raise_ioerror(case, tmp_path):
    path = tmp_path / "bad.pcd"
    path.write_bytes(_malformed(_pcd_bytes(tmp_path), case))
    with pytest.raises(IOError):
        pcd_io.read_pcd(path)
    with pytest.raises(Exception) as plain:  # the plain reader raises too (IOError where it checks the case)
        pcd_io.read_pcd_plain(path)
    if case not in ("no_points", "binary_truncated", "sizes_truncated"):
        assert plain.type is OSError


# --------------------------------------------------------------------------- LZF


def _jax_lzf(comp: bytes, out_len: int) -> tuple[int, bytes]:
    out = ctypes.create_string_buffer(max(out_len, 1))
    return jpcd._load_native().or4d_lzf_decompress(comp, len(comp), out, out_len), out.raw[:out_len]


@pytest.mark.parametrize("seed", [0, 1])
def test_lzf_round_trips(seed):
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, rng.integers(1, 300), dtype=np.uint8).tobytes() for _ in range(40)]
    data = b"".join(blocks[i] * int(rng.integers(1, 4)) + bytes(int(rng.integers(0, 600))) +
                    b"ab" * int(rng.integers(0, 200)) for i in rng.permutation(40))  # long, overlapping references
    comp = pcd_io.lzf_compress(data)
    got = ingest_lib.lzf_decompress(comp, len(data))
    assert got == data == pcd_io.lzf_decompress(comp, len(data))
    if JAX_NATIVE:
        assert _jax_lzf(comp, len(data)) == (len(data), data)
    assert ingest_lib.lzf_decompress(b"", 0) == b""


@pytest.mark.parametrize("stream,size", [
    ("truncated", 0), ("short", -1), ("long", 1), (b"\x05ab", 6), (b"\x00a\xe0", 20), (b"\x00a\x20", 4),
    (b"\x20\x05", 3), (b"\x00a\x21\x00", 4)], ids=["truncated", "short", "long", "literal_past_end",
                                                    "ends_in_long_reference", "ends_in_reference",
                                                    "reference_before_start", "reference_past_end"])
def test_malformed_lzf_raises_as_the_plain_decoder(stream, size):
    if isinstance(stream, str):
        data = bytes(range(50)) * 20
        comp = pcd_io.lzf_compress(data)
        stream, size = (comp[:-1], len(data)) if stream == "truncated" else (comp, len(data) + size)
    with pytest.raises(IOError) as plain:
        pcd_io.lzf_decompress(stream, size)
    with pytest.raises(IOError) as lib:
        ingest_lib.lzf_decompress(stream, size)
    assert str(lib.value) == str(plain.value)


# --------------------------------------------------------------------------- voxel sweep


def _cloud(case: str, dtype) -> np.ndarray:
    rng = np.random.default_rng(CASES.index(case))
    if case == "random":
        xyz = rng.uniform(-1500, 1500, (20000, 3))
    elif case == "duplicates":  # every point many times over: voxels of far more than 8
        base = rng.uniform(-400, 400, (1500, 3))
        xyz = base[rng.integers(0, len(base), 15000)]
    elif case == "boundaries":  # multiples of 5 from a multiple of 5: on every size's voxel faces
        xyz = rng.integers(-60, 60, (12000, 3)) * 5.0
        xyz[:5] = [[-300.0, -300.0, -300.0]] * 5
    elif case == "dense":  # a few voxels at size 15: the first size is already at or below the targets
        xyz = rng.uniform(0, 20, (9000, 3))
    else:  # "few": fewer points than the targets
        xyz = rng.uniform(-800, 800, (700, 3))
    pts = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 3))], 1).astype(dtype)
    return pts


CASES = ["random", "duplicates", "boundaries", "dense", "few"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_voxel_selection_and_sweep_equal_plain_and_jax(case, dtype):
    pts = _cloud(case, dtype)
    for size in (15.0, 40.0, 95.0, 0.5):
        got = ingest_lib.voxel_select(pts, size)
        want = [prep.voxel_downsample_indices(pts[:, :3], size), jprep.voxel_downsample_indices(pts[:, :3], size)]
        if JAX_NATIVE and dtype == np.float32:
            want.append(jpcd.voxel_downsample_indices_native(pts, size))
        assert_same(got, *want)
        if case in ("duplicates", "dense") and size == 15.0:  # voxels of more than 8 points
            assert len(got) < len(pts)
    for target in TARGETS:
        got = prep.downsample_sweep(pts, target)
        want = [prep.downsample_sweep_plain(pts, target)]
        if JAX_NATIVE and dtype == np.float32:
            want.append(jpcd.downsample_sweep_native(pts, target))
        assert_same(got, *want)
        if len(pts) >= target:
            assert_same(prep.calculate_downsample_indices(pts, target, np.random.default_rng(target)),
                         jprep.calculate_downsample_indices(pts, target, np.random.default_rng(target)))


def test_sweep_reads_the_rows_of_a_wider_array_in_place():
    pts = _cloud("random", np.float32)
    pts7 = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], 1)
    assert_same(prep.downsample_sweep(pts7, 4000), prep.downsample_sweep(np.ascontiguousarray(pts[:, :3]), 4000),
                prep.downsample_sweep_plain(pts7, 4000))
    assert_same(prep.downsample_sweep(pts7[::2], 4000), prep.downsample_sweep_plain(pts7[::2], 4000))


@pytest.mark.parametrize("bad", ["too_large", "not_finite"])
def test_grid_that_does_not_fit_raises_value_error(bad):
    pts = np.zeros((100, 3), np.float32)
    pts[1] = 3e28 if bad == "too_large" else np.nan  # (2e27 voxels a side)^3 > 2^64 at size 15
    with pytest.raises(ValueError, match="64 bits" if bad == "too_large" else "not finite"):
        prep.downsample_sweep(pts, 10)
    with pytest.raises(ValueError):
        ingest_lib.voxel_select(pts, 15.0)
    pts[1] = 1e6  # (66,667 voxels a side)^3 fits
    assert_same(ingest_lib.voxel_select(pts, 15.0), prep.voxel_downsample_indices(pts, 15.0))


# --------------------------------------------------------------------------- union crop


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_union_crop_equals_plain_and_jax_on_the_box_faces(dtype):
    rng = np.random.default_rng(11)
    n = 20000
    pts = np.concatenate([rng.uniform(-1000, 1000, (n, 3)), rng.uniform(0, 1, (n, 3))], 1).astype(dtype)
    labels = rng.integers(-1, 6, n).astype(np.int32)
    mn = (pts[labels == 2, :3].min(0) - 0.2).astype(dtype)
    mx = (pts[labels == 4, :3].max(0) + 0.2).astype(dtype)
    mn[:] = np.minimum(mn, -300)
    mx[:] = np.maximum(mx, 300)
    # on the faces: exactly mn or mx on one axis (out), just inside on the others
    for axis in range(3):
        for k, v in enumerate((mn[axis], mx[axis])):
            rows = rng.integers(0, n, 40)
            pts[rows, axis] = v
            pts[rows[:20], (axis + 1) % 3] = np.nextafter(mn[(axis + 1) % 3], mx[(axis + 1) % 3])
    pts[:10, :3] = mn
    pts[10:20, :3] = mx
    idx, mask = prep.crop_union(pts, labels, mn, mx, 2, 4)
    p_idx, p_mask = prep.crop_union_plain(pts, labels, mn, mx, 2, 4)
    assert_same(idx, p_idx)
    assert_same(mask, p_mask)
    assert set(np.unique(mask)) == {0.0, 1.0, 2.0} and not np.isin(np.arange(20), idx).any()
    # the JAX package's numpy branch (prep.py's prepare_scene) on the same box
    inside = np.all((pts[:, :3] > mn) & (pts[:, :3] < mx), axis=1)
    channel = (labels == 2).astype(np.float32) * 1.0 + (labels == 4).astype(np.float32) * 2.0
    assert_same(np.concatenate([pts[idx], mask[:, None]], 1),
                np.concatenate([pts, channel[:, None]], axis=1)[inside])
    if JAX_NATIVE and dtype == np.float32:
        j_idx, j_mask = jpcd.crop_union_native(pts, labels, mn, mx, 2, 4)
        assert_same(idx, j_idx)
        assert_same(mask, j_mask)


# --------------------------------------------------------------------------- build


@pytest.mark.parametrize("cxx", ["missing", "fails"])
def test_build_without_a_working_compiler_raises(cxx, tmp_path, monkeypatch):
    monkeypatch.setattr(ingest_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(ingest_lib, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++") if cxx == "missing" else "false")
    with pytest.raises(RuntimeError, match="not found" if cxx == "missing" else "failed"):
        ingest_lib.library()
    with pytest.raises(RuntimeError):
        pcd_io.read_pcd(PCDS[0])
    assert not any((tmp_path / "build").glob("*.so"))
