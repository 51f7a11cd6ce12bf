"""The port's pose data modules against the JAX package on the CPU, exact
(they are numpy in both packages):

* ``data/cameras.py``: quaternions, the pose-tool transforms both ways,
  ``load_cam_infos`` and ``cam_infos_to_voxelpose`` on the fixture's rig;
* ``data/voxelpose_dataset.py``: ``generate_heatmap`` (target and input
  modes), ``generate_3d_target``, ``load_annotation_bodies``,
  ``project_to_camera`` and every ``VoxelPoseDataset`` sample (GT-rendered
  input heatmaps, and from a ``pred_or_4d_hrnet_coco_*.npz``);
* ``data/higherhrnet_dataset.py``: ``affine_matrix``, ``affine_joints``,
  ``render_heatmaps``, ``warp_affine`` bit-exact against ``cv2.warpAffine``
  on the fixture's frames under the dataset's augmentation draws, and the
  samples and ``batches`` with augmentation from the same generator (the
  JAX module reads frames with OpenCV, the port with its own decoder);
* ``pipeline/ae_grouping.py`` and ``train/pose_metrics.py`` on random
  inputs;
* the synthetic root's pose annotations (``add_pose_annotations``): both
  packages' datasets read the root identically.
"""

from pathlib import Path

import numpy as np
import pytest

from or4d_tpu.data import cameras as jcam
from or4d_tpu.data import higherhrnet_dataset as jhd
from or4d_tpu.data import voxelpose_dataset as jvd
from or4d_tpu.pipeline import ae_grouping as jae
from or4d_tpu.train import pose_metrics as jpm

from or4d_tpu_torch.data import cameras as tcam
from or4d_tpu_torch.data import higherhrnet_dataset as thd
from or4d_tpu_torch.data import voxelpose_dataset as tvd
from or4d_tpu_torch.pipeline import ae_grouping as tae
from or4d_tpu_torch.train import pose_metrics as tpm

ROOT = Path(__file__).parent / "golden" / "real_data"
TAKE1 = ROOT / "export_holistic_take1_processed"


def same(a, b, what=""):
    """Equal trees of arrays / scalars / lists / dicts."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
    else:
        assert a == b, what


def test_cameras_equal_the_jax_module():
    rng = np.random.default_rng(0)
    q = rng.standard_normal(4)
    same(tcam.quat_to_matrix(*q), jcam.quat_to_matrix(*q))
    pts = rng.uniform(-2000, 2000, (20, 3))
    same(tcam.coord_transform_or4d_to_pose_tool(pts), jcam.coord_transform_or4d_to_pose_tool(pts))
    same(tcam.coord_transform_or4d_to_pose_tool(pts[0]), jcam.coord_transform_or4d_to_pose_tool(pts[0]))
    same(tcam.coord_transform_pose_tool_to_or4d(pts), jcam.coord_transform_pose_tool_to_or4d(pts))
    infos = tcam.load_cam_infos(TAKE1)
    same(infos, jcam.load_cam_infos(TAKE1))
    same(tcam.cam_infos_to_voxelpose(infos), jcam.cam_infos_to_voxelpose(infos))
    t = rng.standard_normal((4, 4))
    same(tcam.scale_registered_translation(t), jcam.scale_registered_translation(t))


def test_voxelpose_functions_equal_the_jax_module():
    rng = np.random.default_rng(1)
    joints = rng.uniform(0, 2048, (3, 14, 2)) * [1, 0.75]
    vis = (rng.random((3, 14)) < 0.8).astype(np.float32)
    conf = rng.random((3, 14)).astype(np.float32)
    same(tvd.generate_heatmap(joints, vis), jvd.generate_heatmap(joints, vis))
    same(tvd.generate_heatmap(joints, None, confidence=conf), jvd.generate_heatmap(joints, None, confidence=conf))
    roots = rng.uniform(-2000, 2000, (3, 3))
    same(tvd.generate_3d_target(roots), jvd.generate_3d_target(roots))
    same(tvd.generate_3d_target(roots, cube_size=(12, 12, 12)), jvd.generate_3d_target(roots, cube_size=(12, 12, 12)))
    ann = TAKE1 / "annotations" / "000000.json"
    same(tvd.load_annotation_bodies(ann), jvd.load_annotation_bodies(ann))
    cams = jcam.cam_infos_to_voxelpose(jcam.load_cam_infos(TAKE1))
    for v in range(6):
        same(tvd.project_to_camera(roots, cams, v), jvd.project_to_camera(roots, cams, v))


@pytest.mark.parametrize("pred", [False, True])
def test_voxelpose_dataset_samples_equal_the_jax_dataset(tmp_path, pred):
    path = None
    if pred:  # one camera's prediction of frame 0: input heatmaps from it, the rest from the GT
        rec = jvd.VoxelPoseDataset(ROOT, "train", take_indices=[1]).db[0]
        key = f"1_camera01_colorimage-{rec['channels']['color_1']}.jpg"
        people = np.random.default_rng(2).uniform(100, 1500, (2, 14, 3)) * [1, 1, 1e-3]
        np.savez_compressed(tmp_path / "pred.npz", np.array({key: list(people)}, dtype=object))
        path = tmp_path / "pred.npz"
    for split, kw in (("train", {}), ("val", dict(inference=True, max_people=3))):
        j = jvd.VoxelPoseDataset(ROOT, split, pred_pose2d_path=path, **kw)
        t = tvd.VoxelPoseDataset(ROOT, split, pred_pose2d_path=path, **kw)
        same(t.cameras, j.cameras)
        same(t.heatmap_scale, j.heatmap_scale)
        assert len(t) == len(j) > 0
        for i in range(len(j)):
            same(t.sample(i), j.sample(i), f"{split}[{i}]")


def test_affine_and_heatmaps_equal_the_jax_module():
    rng = np.random.default_rng(3)
    for rot in (0.0, 17.0, -29.5):
        m = thd.affine_matrix((130.0, 90.0), 1.13, (64, 64), rot)
        same(m, jhd.affine_matrix((130.0, 90.0), 1.13, (64, 64), rot))
        xy = rng.uniform(0, 256, (3, 14, 2))
        same(thd.affine_joints(xy, m), jhd.affine_joints(xy, m))
    joints = np.concatenate([rng.uniform(-5, 70, (4, 14, 2)), rng.integers(0, 3, (4, 14, 1))], -1)
    same(thd.render_heatmaps(joints, 64, 14), jhd.render_heatmaps(joints, 64, 14))


@pytest.mark.parametrize("size", [512, 100])
def test_warp_affine_is_bit_exact_against_opencv(size):
    """Every fixture frame, under the dataset's augmentation draws (scale
    0.75-1.5 of the short side, rotation to 30 degrees, translation to 40
    pixels): the same bytes as ``cv2.warpAffine``, including the zero border."""
    import cv2

    from or4d_tpu_torch.data.jpeg import read_jpeg

    rng = np.random.default_rng(size)
    frames = sorted((TAKE1 / "colorimage").glob("*.jpg"))
    assert len(frames) == 12
    for path in frames:
        img = read_jpeg(path).numpy()
        np.testing.assert_array_equal(img, cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB))
        h, w = img.shape[:2]
        scale = min(h, w) / 200.0 * (rng.random() * 0.75 + 0.75)
        center = np.array((w / 2.0, h / 2.0)) + rng.integers(-40, 41, 2)
        mat = thd.affine_matrix(center, scale, (size, size), (rng.random() * 2 - 1) * 30)[:2]
        got = thd.warp_affine(img, mat, (size, size))
        want = cv2.warpAffine(img, mat, (size, size))
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=path.name)


def test_higherhrnet_dataset_equals_the_jax_dataset():
    """Samples without augmentation, then augmented ``batches`` (shuffled,
    flips, rotations and scales from one ``np.random.Generator``)."""
    kw = dict(take_indices=[1], input_size=64, output_sizes=(16, 32), max_people=4)
    j = jhd.HigherHRNetDataset(ROOT, "train", augment=False, **kw)
    t = thd.HigherHRNetDataset(ROOT, "train", augment=False, **kw)
    same([{k: v for k, v in d.items()} for d in t.image_dicts], j.image_dicts)
    for i in range(len(j)):
        same(t.sample(i), j.sample(i), str(i))
    j = jhd.HigherHRNetDataset(ROOT, "train", augment=True, **kw)
    t = thd.HigherHRNetDataset(ROOT, "train", augment=True, **kw)
    for a, b in zip(t.batches(3, shuffle=True, seed=5, limit=9), j.batches(3, shuffle=True, seed=5, limit=9),
                    strict=True):
        same(a, b)


def test_ae_grouping_equals_the_jax_module():
    """Two people with separated tags, a weak third and noise."""
    rng = np.random.default_rng(4)
    J, H, W = 14, 32, 32
    det = rng.random((J, H, W)).astype(np.float32) * 0.05
    tag = rng.standard_normal((J, H, W)).astype(np.float32) * 0.05
    for p, (t0, v) in enumerate(((0.0, 0.9), (3.0, 0.7), (6.0, 0.15))):
        xs, ys = rng.integers(0, W, J), rng.integers(0, H, J)
        det[np.arange(J), ys, xs] = v
        tag[np.arange(J), ys, xs] = t0 + rng.standard_normal(J) * 0.1
    same(tae.nms_heatmaps(det), jae.nms_heatmaps(det))
    same(tae.top_k(det, tag[..., None]), jae.top_k(det, tag[..., None]))
    same(tae.match_by_tag(*jae.top_k(det, tag[..., None]), num_joints=J),
         jae.match_by_tag(*jae.top_k(det, tag[..., None]), num_joints=J))
    got, want = tae.parse_heatmaps(det, tag), jae.parse_heatmaps(det, tag)
    same(got, want)
    assert len(want[0]) >= 2


def test_pose_metrics_equal_the_jax_module():
    rng = np.random.default_rng(5)
    gt = rng.uniform(-1000, 1000, (3, 14, 3))
    pred = gt[[2, 0]] + rng.normal(scale=60.0, size=(2, 14, 3))
    same(tpm.match_poses(pred, gt), jpm.match_poses(pred, gt))
    for f in ("mpjpe", "pcp", "recall_at"):
        same(getattr(tpm, f)(pred, gt), getattr(jpm, f)(pred, gt), f)
    preds = [pred, np.zeros((0, 14, 3)), gt]
    gts = [list(gt), list(gt[:1]), list(gt)]
    same(tpm.voxelpose_evaluate(preds, gts), jpm.voxelpose_evaluate(preds, gts))


def test_synthetic_root_pose_annotations_read_identically(tmp_path):
    """A synthetic root with frames, the fixture's rig and the scans'
    skeletons: every ``VoxelPoseDataset`` and ``HigherHRNetDataset`` sample
    of the JAX package and of the port are equal; the 3D annotations give
    back the GT joints; deterministic."""
    from or4d_tpu_torch.data.synthetic_root import add_camera_frames, add_pose_annotations, write_data_root

    root = tmp_path / "root"
    write_data_root(root, seed=3, scans_per_take=2, points_per_object=50, floor_points=50)
    add_camera_frames(root, TAKE1 / "colorimage", scans_per_take=2)
    assert add_pose_annotations(root, TAKE1) == 10
    first = {f: f.read_bytes() for f in sorted(root.rglob("*.json"))}
    assert add_pose_annotations(root, TAKE1) == 10
    assert {f: f.read_bytes() for f in sorted(root.rglob("*.json"))} == first
    gt = np.load(root / "human_name_to_3D_joints" / "1_GT_True.npz", allow_pickle=True)["arr_0"].item()
    bodies, _patient, names = tvd.load_annotation_bodies(root / "export_holistic_take1_processed" / "annotations"
                                                         / "000001.json")
    np.testing.assert_allclose(np.stack(bodies), np.stack([gt["000001"][n] for n in names]), atol=1e-9)
    for split in ("train", "val"):
        j, t = jvd.VoxelPoseDataset(root, split), tvd.VoxelPoseDataset(root, split)
        assert len(t) == len(j) == 2 * len(jvd.TAKE_SPLIT[split])
        for i in (0, len(j) - 1):
            same(t.sample(i), j.sample(i))
    kw = dict(input_size=64, output_sizes=(16, 32))
    j, t = jhd.HigherHRNetDataset(root, "train", **kw), thd.HigherHRNetDataset(root, "train", **kw)
    assert len(t) == len(j) == 72
    for a, b in zip(t.batches(4, shuffle=True, seed=1, limit=8), j.batches(4, shuffle=True, seed=1, limit=8),
                    strict=True):
        same(a, b)
        assert a["joint_valid"].any()
