"""Group-Free detection from disk on the CPU:

* ``pipeline.perception_infer.run_detection_inference`` writes the same
  ``{take}_{scan}.npz`` box files as the JAX package's from converted weights
  (16 proposals, 2 decoder layers) on the fixture's scans: the same files
  and keys, classes and dtypes equal, boxes and scores within 1e-5 of their
  largest value, each side with its own ret-dict cache; ``infer_boxes`` of
  one scan writes the same file. Trap guard: the
  JAX FPS and ball query select what the port's do at every SA level of
  those clouds;
* ``python -m or4d_tpu_torch.cli perception --task detect-train`` (one
  epoch, a checkpoint) then ``--task detect-infer --split test`` from that
  checkpoint on a root written by ``data/synthetic_root.py``, and
  ``instance-labels --boxes-dir`` on the boxes it wrote: the L1 -> L2 chain.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from or4d_tpu import ops as jops
from or4d_tpu.data.groupfree_dataset import GroupFreeDetectionDataset as JaxDataset
from or4d_tpu.models import groupfree as jgf
from or4d_tpu.ops.ball_query import ball_query as jax_ball_query
from or4d_tpu.pipeline import perception_infer as jpi

from or4d_tpu_torch import cli
from or4d_tpu_torch.convert import groupfree_from_jax_variables
from or4d_tpu_torch.data.groupfree_dataset import GroupFreeDetectionDataset
from or4d_tpu_torch.models.groupfree import GroupFreeDetector
from or4d_tpu_torch.ops.ball_query import ball_query
from or4d_tpu_torch.ops.fps import furthest_point_sample
from or4d_tpu_torch.pipeline import perception_infer as tpi
from or4d_tpu_torch.pipeline.instance_labels import load_boxes_npz

ROOT = Path(__file__).parent / "golden" / "real_data"
KEYS = {"bboxes", "scores", "classes", "classes_nms", "bboxes_nms", "scores_nms"}


def test_detection_npz_equal_the_jax_package(tmp_path):
    kw = dict(num_points=4096, max_num_obj=8)
    jds = JaxDataset(ROOT, "train", cache_dir=tmp_path / "jc", **kw)
    tds = GroupFreeDetectionDataset(ROOT, "train", cache_dir=tmp_path / "tc", **kw)
    xyz = np.stack([jds[i]["point_clouds"][:, :3] for i in range(len(jds))])
    for npoint, radius, ns in ((2048, 0.2, 64), (1024, 0.4, 32), (512, 0.8, 16), (256, 1.2, 16)):
        idx = furthest_point_sample(torch.from_numpy(np.ascontiguousarray(xyz)), npoint).numpy()
        np.testing.assert_array_equal(idx, np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), npoint)))
        new = np.take_along_axis(xyz, idx[..., None].astype(np.int64), 1)
        np.testing.assert_array_equal(
            ball_query(radius, ns, torch.from_numpy(np.ascontiguousarray(xyz)), torch.from_numpy(new)).numpy(),
            np.asarray(jax_ball_query(radius, ns, jnp.asarray(xyz), jnp.asarray(new))))
        xyz = new

    jm = jgf.GroupFreeDetector(num_proposal=16, num_decoder_layers=2)
    pc0 = jnp.asarray(jds[0]["point_clouds"][None])
    variables = jax.jit(lambda k: jm.init(k, pc0, jnp.asarray(jds.mean_size_arr()), train=False))(jax.random.key(3))
    assert jpi.run_detection_inference(jm, variables, jds, tmp_path / "jax") == 2
    tm = GroupFreeDetector(num_proposal=16, num_decoder_layers=2, device="cpu")
    tm.load_state_dict(groupfree_from_jax_variables(jax.tree_util.tree_map(np.asarray, variables), tm))
    assert tpi.run_detection_inference(tm, tds, tmp_path / "port") == 2
    # the single-scan entry point writes the same file
    one = tpi.infer_boxes(tm, tds[0]["point_clouds"], tds.mean_size_arr(), tmp_path / "one.npz")
    for key, value in load_boxes_npz(tmp_path / "port" / "1_000000.npz").items():
        np.testing.assert_array_equal(one[key], value, err_msg=key)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == ["1_000000.npz", "1_000001.npz"]
    for name in names:
        want, got = load_boxes_npz(tmp_path / "jax" / name), load_boxes_npz(tmp_path / "port" / name)
        assert set(want) == set(got) == KEYS and len(want["scores"]) > 0 and len(want["scores_nms"]) > 0
        for key in KEYS:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, (name, key)
            if key.startswith("classes"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
            else:
                scale = float(np.abs(want[key]).max())
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5 * scale, err_msg=f"{name} {key}")


def test_detect_train_infer_then_instance_labels_from_a_synthetic_root(tmp_path, monkeypatch, capsys):
    from or4d_tpu_torch.data.synthetic_root import write_data_root

    monkeypatch.chdir(tmp_path)
    write_data_root(tmp_path / "root", seed=1, scans_per_take=1, n_staff=2, points_per_object=150, floor_points=200)
    root = str(tmp_path / "root")
    base = ["perception", "--data-root", root, "--checkpoint-dir", "gf", "--device", "cpu"]
    assert cli.main([*base, "--task", "detect-train", "--limit", "2"]) == 0
    out = capsys.readouterr().out
    assert "detect epoch 0: loss=" in out and "(1 steps)" in out
    assert [p.name for p in (tmp_path / "gf").iterdir()] == ["step_00000001.pt"]
    # every train scan's ret dict is cached: the mean sizes read them all
    cache = tmp_path / "root" / "preprocessed_ret_dicts"
    assert len(list(cache.glob("*_20000.npz"))) == 6 and (cache / "OR_4D_means.npz").exists()

    preds = tmp_path / "preds"
    assert cli.main([*base, "--task", "detect-infer", "--split", "test", "--output-dir", str(preds)]) == 0
    out = capsys.readouterr().out
    assert f"wrote 2 box npz files -> {preds}" in out and "RANDOM INITIALIZATION" not in out
    assert sorted(p.name for p in preds.iterdir()) == ["2_000000.npz", "6_000000.npz"]
    for p in preds.iterdir():
        boxes = load_boxes_npz(p)
        assert set(boxes) == KEYS and boxes["bboxes"].shape == (128, 7) and boxes["bboxes_nms"].shape[1] == 7
        assert boxes["classes"].dtype == np.int32 and np.isfinite(boxes["bboxes"]).all()

    assert cli.main(["instance-labels", "--data-root", root, "--boxes-dir", str(preds), "--device", "cpu",
                     "--output-dir", "l2"]) == 0
    for scan in ("2_000000", "6_000000"):
        labels = np.load(tmp_path / "l2" / "instance_labels_pred" / f"{scan}.npz")["arr_0"]
        assert labels.dtype == np.int8 and labels.shape == (1250,)
