"""The port's disk ingest against the JAX package, on the real-format fixture
``tests/golden/real_data`` (two takes in the release layout):

* PCD: ``or4d_tpu_torch.data.pcd_io.read_pcd`` equals
  ``or4d_tpu.data.pcd_io.read_pcd`` (the native reader) exactly on the
  fixture's binary and ascii pcds, and on ``binary_compressed`` files the
  port writes, whose LZF streams hold literal runs and back references (the
  JAX side decodes them with its native LZF); a compressed read equals the
  binary read of the same points. PLY reads and registered object scans
  equal the JAX package's.
* ORDataset: samples equal the JAX ``ORDataset``'s field for field and
  exactly (dtype included) for train with GT objects, val ``for_eval``
  without GT (objects from the predicted labels) and pair-shared train
  crops without GT (human matching), on the tiny config of
  ``tests/test_real_ingest.py``; loss weights; the synthetic scan list of
  ``synthetic_fallback``; ``synthetic_fallback=False`` raising on a root
  with a missing pcd. The two datasets always get different cache
  directories, so neither reads the other's samples.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

import or4d_tpu.config as JC
from or4d_tpu.data import pcd_io as jpcd
from or4d_tpu.data.dataset import ORDataset as JORDataset
from or4d_tpu.data.vocab import DEFAULT_VOCAB as J_VOCAB

import or4d_tpu_torch.config as TC
from or4d_tpu_torch.data import pcd_io
from or4d_tpu_torch.data.dataset import ORDataset, default_cache_dir
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB

ROOT = Path(__file__).parent / "golden" / "real_data"
PCDS = sorted(ROOT.glob("export_holistic_take*_processed/pcds/*.pcd"))
FIELDS = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask", "edge_mask",
          "rel_hand_points")


def tiny_cfg(C, use_gt):
    """The tiny config of tests/test_real_ingest.py, from config module C."""
    return C.ExperimentConfig(
        dataset=C.DatasetConfig(num_points_objects=96, num_points_relation=128, max_objects=6, max_edges=30,
                                data_augmentation=False),
        lr=1e-3, use_gt=use_gt,
        model=C.ModelConfig(sa_npoints=(32, 16), sa_nsamples=((4, 8), (8, 8))),
        tpu=C.TPUConfig(scene_batch=2),
    )


def assert_samples_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (f, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.scan_id, a.take_idx, tuple(a.slot_names)) == (b.scan_id, b.take_idx, tuple(b.slot_names))


# --------------------------------------------------------------------------- PCD


def test_fixture_has_both_uncompressed_encodings():
    modes = {p.read_bytes().split(b"DATA ")[1].split(b"\n")[0] for p in PCDS}
    assert modes == {b"binary", b"ascii"}


@pytest.mark.parametrize("path", PCDS, ids=lambda p: f"take{p.parts[-3][21]}_{p.stem}")
def test_read_pcd_equals_jax_on_fixture(path):
    got, want = pcd_io.read_pcd(path), jpcd.read_pcd(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _lzf_tokens(stream: bytes) -> tuple[int, int]:
    """(literal runs, back references) of an LZF stream."""
    lit = ref = 0
    i = 0
    while i < len(stream):
        ctrl = stream[i]
        if ctrl < 32:
            lit += 1
            i += 1 + ctrl + 1
        else:
            ref += 1
            i += 2 + ((ctrl >> 5) == 7)
    return lit, ref


def _compressed_points(seed=0, n=3000):
    """Millimetre points on a coarse grid (repeated bytes: back references)
    mixed with free points (literal runs)."""
    rng = np.random.default_rng(seed)
    xyz = np.round(rng.uniform(-1500, 1500, (n, 3)) / 50.0) * 50.0
    xyz[::3] += rng.normal(scale=7.0, size=xyz[::3].shape)
    rgb = np.repeat(rng.uniform(0, 1, (n // 100, 3)), 100, axis=0)
    return np.concatenate([xyz, rgb], axis=1).astype(np.float32)


def test_binary_compressed_equals_jax_native_and_binary(tmp_path):
    pts = _compressed_points()
    comp, binary = tmp_path / "c.pcd", tmp_path / "b.pcd"
    pcd_io.write_pcd(comp, pts, compressed=True)
    pcd_io.write_pcd(binary, pts)
    body = comp.read_bytes().split(b"DATA binary_compressed\n", 1)[1]
    csize, rsize = np.frombuffer(body[:8], "<u4")
    assert rsize == 16 * len(pts) and csize == len(body) - 8 < rsize
    lit, ref = _lzf_tokens(body[8:])
    assert lit > 10 and ref > 10, (lit, ref)
    assert jpcd.native_available()  # the JAX side decodes through its native LZF
    got = pcd_io.read_pcd(comp)
    np.testing.assert_array_equal(got, jpcd.read_pcd(comp))
    np.testing.assert_array_equal(got, pcd_io.read_pcd(binary))
    np.testing.assert_array_equal(got, jpcd.read_pcd(binary))
    # field-major: the decompressed body is every x, then every y, ...
    raw = pcd_io.lzf_decompress(body[8:], int(rsize))
    np.testing.assert_array_equal(np.frombuffer(raw, "<f4", count=len(pts)), pts[:, 0])


@pytest.mark.parametrize("data", [b"", b"x", b"abc" * 400, bytes(range(256)) * 3, bytes(9000)])
def test_lzf_roundtrip_and_truncation(data):
    comp = pcd_io.lzf_compress(data)
    assert pcd_io.lzf_decompress(comp, len(data)) == data
    if comp:
        with pytest.raises(IOError):
            pcd_io.lzf_decompress(comp[:-1], len(data))
        with pytest.raises(IOError):
            pcd_io.lzf_decompress(comp, len(data) + 1)


def test_ply_and_registered_scans_equal_jax():
    plys = sorted(ROOT.glob("object_scans/*/*.ply"))
    assert len(plys) >= 5
    t = np.eye(4)
    t[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    t[:3, 3] = [0.1, -0.2, 0.3]
    for p in plys:
        np.testing.assert_array_equal(pcd_io.read_ply(p), jpcd.read_ply(p))
        np.testing.assert_array_equal(pcd_io.load_registered_object_scan(p, t), jpcd.load_registered_object_scan(p, t))


# --------------------------------------------------------------------------- ORDataset

DATASET_CASES = {
    "train_gt": (True, "train", {}),
    "val_for_eval_no_gt": (False, "val", {"for_eval": True}),
    "train_pair_shared_no_gt": (False, "train", {"pair_shared": True}),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_ordataset_samples_equal_jax(case, tmp_path):
    use_gt, split, kw = DATASET_CASES[case]
    jds = JORDataset(tiny_cfg(JC, use_gt), split, J_VOCAB, data_root=ROOT, cache_dir=tmp_path / "jax",
                     synthetic_fallback=False, **kw)
    tds = ORDataset(tiny_cfg(TC, use_gt), split, DEFAULT_VOCAB, data_root=ROOT, cache_dir=tmp_path / "port",
                    synthetic_fallback=False, **kw)
    assert tds.cache_dir != jds.cache_dir and tds.cache_dir.name == jds.cache_dir.name
    assert tds.scans == jds.scans and (tds.n_real, tds.n_synthetic) == (jds.n_real, 0)
    for i in range(len(jds)):
        assert_samples_equal(tds.sample(i), jds.sample(i))
    for w, jw in zip(tds.weights(), jds.weights()):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(jw))
    # the port's own cache: a second dataset reads the npz and gets the same sample
    again = ORDataset(tiny_cfg(TC, use_gt), split, DEFAULT_VOCAB, data_root=ROOT, cache_dir=tmp_path / "port",
                      synthetic_fallback=False, **kw)
    assert len(list(tds.cache_dir.glob("*.npz"))) == len(tds)
    assert_samples_equal(again.sample(0), jds.sample(0))
    if case == "val_for_eval_no_gt":
        assert tds.scans[0]["relationships"] == [] and "instrument" in tds.sample(0).slot_names


def test_batches_equal_jax(tmp_path):
    jds = JORDataset(tiny_cfg(JC, True), "train", J_VOCAB, data_root=ROOT, cache_dir=tmp_path / "j")
    tds = ORDataset(tiny_cfg(TC, True), "train", DEFAULT_VOCAB, data_root=ROOT, cache_dir=tmp_path / "t")
    jb = list(jds.batches(1, shuffle=True, seed=3))
    tb = list(tds.batches(1, shuffle=True, seed=3))
    assert [b.scan_ids for b in tb] == [b.scan_ids for b in jb] and len(tb) == 2
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb[1], f), np.asarray(getattr(jb[1], f)))


def test_synthetic_fallback_equals_jax(tmp_path):
    """No relationships json: the seeded synthetic scan list and its
    synthesized geometry."""
    empty = tmp_path / "empty"
    empty.mkdir()
    jds = JORDataset(tiny_cfg(JC, True), "val", J_VOCAB, data_root=empty, cache_dir=tmp_path / "j",
                     synthetic_scans_per_take=2)
    tds = ORDataset(tiny_cfg(TC, True), "val", DEFAULT_VOCAB, data_root=empty, cache_dir=tmp_path / "t",
                    synthetic_scans_per_take=2)
    assert tds.synthetic_scan_list and tds.scans == jds.scans and len(tds) == 4
    for i in (0, 3):
        assert_samples_equal(tds.sample(i), jds.sample(i))
    with pytest.raises(RuntimeError, match="no scans"):
        ORDataset(tiny_cfg(TC, True), "val", DEFAULT_VOCAB, data_root=empty, cache_dir=tmp_path / "t",
                  synthetic_fallback=False)


def test_strict_data_raises_on_a_missing_pcd(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("colorimage", "object_scans"))
    (root / "export_holistic_take1_processed" / "pcds" / "000001.pcd").unlink()
    for ds_cls, C, vocab in ((JORDataset, JC, J_VOCAB), (ORDataset, TC, DEFAULT_VOCAB)):
        with pytest.raises(RuntimeError, match=r"synthetic_fallback=False but 1 scans have no raw geometry"):
            ds_cls(tiny_cfg(C, True), "train", vocab, data_root=root, cache_dir=tmp_path / ds_cls.__module__,
                   synthetic_fallback=False)
    # with the fallback the scan's geometry is synthesized, on both sides alike
    jds = JORDataset(tiny_cfg(JC, True), "train", J_VOCAB, data_root=root, cache_dir=tmp_path / "j")
    tds = ORDataset(tiny_cfg(TC, True), "train", DEFAULT_VOCAB, data_root=root, cache_dir=tmp_path / "t")
    assert (tds.n_real, tds.n_synthetic) == (jds.n_real, jds.n_synthetic) == (1, 1)
    assert_samples_equal(tds.sample(1), jds.sample(1))


def test_cache_is_the_ports_own_and_image_branch_refused(tmp_path):
    """The sample cache is the port's own. The image branch was refused
    until the port had one; it is now taken, and a sample's six frames
    equal the JAX package's (its frames read with PIL) bit for bit."""
    assert default_cache_dir().name == "or4d_torch_cache"
    cfg = tiny_cfg(TC, True)
    assert json.loads(json.dumps(cfg.image_input)) is False
    import dataclasses

    img = lambda C, c: dataclasses.replace(c, image_input="full", model=dataclasses.replace(c.model, image_size=64))
    ds = ORDataset(img(TC, cfg), "train", DEFAULT_VOCAB, data_root=ROOT, cache_dir=tmp_path / "port")
    jds = JORDataset(img(JC, tiny_cfg(JC, True)), "train", J_VOCAB, data_root=str(ROOT), cache_dir=str(tmp_path / "jax"))
    got, want = ds.sample(0), jds.sample(0)
    assert got.images.shape == (6, 64, 64, 3) and got.images.dtype == np.float32
    np.testing.assert_array_equal(got.images, want.images)