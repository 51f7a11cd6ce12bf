"""L2 instance labels and the L4 heuristics of the port against the JAX
package, on the real-format fixture ``tests/golden/real_data``.

L2 (``or4d_tpu_torch.pipeline.instance_labels``, ``cli instance-labels``):
the GT path (registered object scans and annotation-json humans,
``process_take(from_gt=True)``), the predicted path in dataset mode
(Group-Free boxes and VoxelPose poses written here from the fixture's GT
labels and joints) and loose-directory mode (``--pcd-dir``). Labels must
equal the JAX package's exactly; the one allowed exception is a point whose
float64 minimum squared distance to the samples of some distance test of its
scan lies within 2 mm^2 of that test's threshold^2 (75^2, or 150^2 near the
wrists): there the f32 ``|a|^2 + |b|^2 - 2ab`` expansion may round to either
side on XLA's CPU einsum and on PyTorch's matmul. Such points are listed in
the failure message.

FPS: the JAX package on the CPU computes FPS distances with XLA, which
contracts ``dx*dx + dy*dy + dz*dz`` into fused multiply-adds (``_fps_xla``,
and the Pallas kernel in interpret mode); the port rounds each product and
sum as the TPU kernel does (``(dx*dx + dy*dy) + dz*dz``, ``csrc/fps.cu``).
On L2's clouds (20^3 box grids, limb rings) many running distances tie
exactly, and the two round the ties apart. So the JAX side's ``_fps_sample``
is replaced here by ``tpu_fps``, a numpy model of the TPU kernel's
arithmetic, and ``test_fps_on_the_l2_clouds`` holds the port's indices
exactly equal to that model on every cloud L2 samples in the fixture, and
shows that where they differ from JAX's CPU FPS, the first differing step
picks one of two points whose running distances, in float64, lie within 4
float32 ulps of each other: a tie that the two roundings break apart
(ROADMAP Queue 3).

L4 (``roles``, ``phases``, ``phases-eval``): the port's CLI writes the same
JSON (and prints the same reports) as ``or4d_tpu.cli`` on the same
``scan_relations`` input.
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or4d_tpu import cli as jcli
from or4d_tpu import ops as jops
from or4d_tpu.pipeline import instance_labels as jil

from or4d_tpu_torch import cli
from or4d_tpu_torch.data.pcd_io import read_pcd
from or4d_tpu_torch.ops.fps import furthest_point_sample
from or4d_tpu_torch.pipeline import instance_labels as til

ROOT = Path(__file__).parent / "golden" / "real_data"
SCANS = [(1, "000000"), (1, "000001"), (4, "000000")]
BOUNDARY_MM2 = 2.0


def tpu_fps(points: np.ndarray, n: int) -> np.ndarray:
    """FPS indices in the TPU kernel's float32 arithmetic: each product and
    sum rounded, ``(dx*dx + dy*dy) + dz*dz``; ties to the lowest index."""
    x = np.asarray(points, np.float32)
    mag = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    mind = np.where(mag > np.float32(1e-3), np.float32(np.inf), np.float32(-1.0)).astype(np.float32)
    idx, sel = [0], 0
    for _ in range(1, n):
        d = x - x[sel]
        mind = np.minimum(mind, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        sel = int(np.argmax(mind))
        idx.append(sel)
    return np.asarray(idx)


@pytest.fixture
def jax_tpu_fps(monkeypatch):
    monkeypatch.setattr(jil, "_fps_sample", lambda points, n: points[tpu_fps(points, n)])


@pytest.fixture
def recorded(monkeypatch):
    """The port's FPS clouds and distance tests (samples, threshold), as L2
    calls them."""
    rec = {"clouds": [], "tests": []}
    fps, close = til.furthest_point_sample, til.close_mask

    def fps_rec(xyz, n):
        rec["clouds"].extend(c.numpy().copy() for c in xyz)
        return fps(xyz, n)

    def close_rec(points, samples, bbox, threshold):
        rec["tests"].append((samples.double().numpy(), float(threshold)))
        return close(points, samples, bbox, threshold)

    monkeypatch.setattr(til, "furthest_point_sample", fps_rec)
    monkeypatch.setattr(til, "close_mask", close_rec)
    return rec


def assert_labels_match(got: np.ndarray, want: np.ndarray, points: np.ndarray, tests, what: str):
    """Exact, but for points at a distance test's threshold (listed)."""
    assert got.dtype == want.dtype == np.int8 and got.shape == want.shape, what
    diff = np.nonzero(got != want)[0]
    off = []
    for i in diff:
        p = points[i].astype(np.float64)
        near = [abs(((s - p) ** 2).sum(1).min() - thr * thr) for s, thr in tests]
        if min(near) > BOUNDARY_MM2:
            off.append((int(i), int(got[i]), int(want[i]), float(min(near))))
    listed = [(int(i), int(got[i]), int(want[i])) for i in diff]
    assert not off, f"{what}: labels differ away from every threshold: {off}; all differing points: {listed}"


def _boxes_and_poses(tmp_path, names_by_scan):
    """Group-Free box npzs (one box per furniture class, from the GT labels'
    extent, sizes in metres) and VoxelPose pose npys (the GT joints) for the
    fixture's scans, under the given file names; returns the two dirs and
    the number of clouds L2 samples from them."""
    boxes_dir, poses_dir = tmp_path / "boxes", tmp_path / "poses"
    boxes_dir.mkdir()
    poses_dir.mkdir()
    rng = np.random.default_rng(5)
    n_clouds = 0
    for take, scan in SCANS:
        pts = read_pcd(ROOT / f"export_holistic_take{take}_processed" / "pcds" / f"{scan}.pcd")[:, :3]
        gt = np.load(ROOT / "instance_labels" / f"{take}_{scan}.npz")["arr_0"]
        classes, boxes = [], []
        for c in (0, 1, 2, 3):
            if (gt == c).sum():
                p = pts[gt == c].astype(np.float64)
                boxes.append(np.r_[(p.min(0) + p.max(0)) / 2000.0, (p.max(0) - p.min(0)) / 1000.0,
                                   rng.uniform(-0.3, 0.3)])
                classes.append(c)
        np.savez_compressed(boxes_dir / f"{names_by_scan(take, scan)}.npz", {
            "classes_nms": np.asarray(classes), "bboxes_nms": np.stack(boxes),
            "scores_nms": rng.uniform(0.5, 1.0, len(classes))})
        joints = np.load(ROOT / "human_name_to_3D_joints" / f"{take}_GT_True.npz", allow_pickle=True)["arr_0"].item()
        np.save(poses_dir / f"pred_{take}_{scan}.npy", np.stack([j for _n, j in sorted(joints[scan].items())]))
        n_clouds += len(classes) + len(joints[scan])
    return boxes_dir, poses_dir, n_clouds


def _compare_dirs(jdir: Path, tdir: Path, recorded, points_of):
    files = sorted(p.name for p in jdir.glob("*.npz"))
    assert files and files == sorted(p.name for p in tdir.glob("*.npz"))
    for name in files:
        want, got = np.load(jdir / name)["arr_0"], np.load(tdir / name)["arr_0"]
        assert (got >= 0).sum() > 100, name
        assert_labels_match(got, want, points_of(name), recorded["tests"], name)


def _points(take, scan):
    return read_pcd(ROOT / f"export_holistic_take{take}_processed" / "pcds" / f"{scan}.pcd")[:, :3]


def test_l2_gt_path_equals_jax(tmp_path, jax_tpu_fps, recorded):
    for take in (1, 4):
        assert jil.process_take(ROOT, take, from_gt=True, out_root=tmp_path / "jax") == til.process_take(
            ROOT, take, from_gt=True, out_root=tmp_path / "port", device="cpu")
        joints = [np.load(tmp_path / side / "human_name_to_3D_joints" / f"{take}_GT_True.npz",
                          allow_pickle=True)["arr_0"].item() for side in ("jax", "port")]
        assert joints[0].keys() == joints[1].keys()
        for scan in joints[0]:
            assert joints[0][scan].keys() == joints[1][scan].keys()
            for name in joints[0][scan]:
                np.testing.assert_array_equal(joints[1][scan][name], joints[0][scan][name])
    _compare_dirs(tmp_path / "jax" / "instance_labels", tmp_path / "port" / "instance_labels", recorded,
                  lambda name: _points(*name[:-4].split("_")))


def test_l2_pred_path_cli_equals_jax(tmp_path, jax_tpu_fps, recorded):
    boxes_dir, poses_dir, n_clouds = _boxes_and_poses(tmp_path, lambda take, scan: f"{take}_{scan}")
    args = ["instance-labels", "--data-root", str(ROOT), "--boxes-dir", str(boxes_dir), "--poses-dir", str(poses_dir)]
    assert jcli.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert len(recorded["clouds"]) == n_clouds and 8000 in {len(c) for c in recorded["clouds"]}
    _compare_dirs(tmp_path / "jax" / "instance_labels_pred", tmp_path / "port" / "instance_labels_pred", recorded,
                  lambda name: _points(*name[:-4].split("_")))
    for take, scan in SCANS:  # every predicted human labels points
        labels = np.load(tmp_path / "port" / "instance_labels_pred" / f"{take}_{scan}.npz")["arr_0"]
        for name in til.poses_from_npy(poses_dir / f"pred_{take}_{scan}.npy"):
            assert (labels == til.OBJECT_LABEL_MAP[name]).any(), (take, scan, name)


def test_l2_loose_directory_mode_equals_jax(tmp_path, jax_tpu_fps, recorded):
    pcd_dir = tmp_path / "pcds"
    pcd_dir.mkdir()
    for take, scan in SCANS:
        shutil.copy(ROOT / f"export_holistic_take{take}_processed" / "pcds" / f"{scan}.pcd",
                    pcd_dir / f"{take}_{scan}.pcd")
    boxes_dir, poses_dir, _n = _boxes_and_poses(tmp_path, lambda take, scan: f"{take}_{scan}")
    args = ["instance-labels", "--pcd-dir", str(pcd_dir), "--boxes-dir", str(boxes_dir), "--poses-dir", str(poses_dir)]
    assert jcli.main(args + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    _compare_dirs(tmp_path / "jax", tmp_path / "port", recorded, lambda name: _points(*name[:-4].split("_")))


def test_a_collapsed_skeleton_labels_no_points(jax_tpu_fps, recorded):
    """A predicted pose with every joint at one point (a barely trained
    VoxelPose's soft-argmax over a flat heatmap puts them there) has no limb
    surface: the JAX package gives a zero-length limb no surface points, and
    labels a point only within 75 (150 at the wrists) of a surface sample.
    So it labels nothing: beside the fixture's skeletons the port labels as
    the JAX package does without it (which raises on the empty surface)."""
    take, scan = 1, "000001"
    points = _points(take, scan)
    joints = np.load(ROOT / "human_name_to_3D_joints" / f"{take}_GT_True.npz", allow_pickle=True)["arr_0"].item()[scan]
    collapsed = np.repeat(joints["human_0"][:1], 14, axis=0)
    part = joints["human_0"].copy()
    part[[9, 11]] = part[[8, 10]]  # two limbs of zero length
    np.testing.assert_array_equal(til.skeleton_to_limb_points(part), jil.skeleton_to_limb_points(part))
    assert til.skeleton_to_limb_points(collapsed).shape == (0, 3)
    with pytest.raises(ValueError):
        jil.skeleton_to_limb_points(collapsed)
    start = np.full(len(points), -1, np.int8)
    want = jil.label_humans(points, joints, start.copy())
    got = til.label_humans(torch.from_numpy(points), {**joints, "human_2": collapsed}, start.copy())
    assert_labels_match(got, want, points, recorded["tests"], scan)
    assert all((got == til.OBJECT_LABEL_MAP[name]).sum() > 100 for name in joints)


def test_fps_on_the_l2_clouds(tmp_path, recorded):
    """Every cloud L2 samples on the fixture (GT and predicted paths): the
    port's FPS equals the TPU-arithmetic model exactly; JAX's CPU FPS
    either equals it or first departs at a tie within float32 rounding."""
    for take in (1, 4):
        til.process_take(ROOT, take, from_gt=True, out_root=tmp_path / "gt", device="cpu")
    n_gt = len(recorded["clouds"])
    boxes_dir, poses_dir, n_pred = _boxes_and_poses(tmp_path, lambda take, scan: f"{take}_{scan}")
    for take in (1, 4):
        til.process_take(ROOT, take, out_root=tmp_path / "pred", boxes_dir=boxes_dir, poses_dir=poses_dir,
                         device="cpu")
    clouds = recorded["clouds"]
    sizes = sorted({len(c) for c in clouds})
    assert len(clouds) == n_gt + n_pred and n_gt > 10 and sizes[0] == 400 and sizes[-1] == 8000, sizes
    same, differ = 0, []
    for cloud in clouds:
        got = furthest_point_sample(torch.from_numpy(cloud[None]), til.NPOINTS)[0].numpy()
        np.testing.assert_array_equal(got, tpu_fps(cloud, til.NPOINTS))
        jax_idx = np.asarray(jops.furthest_point_sample(jnp.asarray(cloud[None]), til.NPOINTS)[0])
        if np.array_equal(jax_idx, got):
            same += 1
            continue
        j = int(np.nonzero(jax_idx != got)[0][0])
        x = cloud.astype(np.float64)
        mind = np.min([((x - x[k]) ** 2).sum(1) for k in got[:j]], axis=0)
        a, b = mind[got[j]], mind[jax_idx[j]]
        assert abs(a - b) <= 4 * np.spacing(np.float32(a)), (len(cloud), j, a, b)
        differ.append((len(cloud), j, float(abs(a - b))))
    # the registered object scans (random points) and some limb clouds agree;
    # the grids and most limb clouds part at a tie (ROADMAP Queue 3)
    assert same >= 10 and len(differ) >= 10, (same, differ)


# --------------------------------------------------------------------------- L4


def _walk(take: int, split: int) -> dict:
    """scan_relations of one take (keys with the _{split} suffix) whose
    humans do what the 8-phase FSM and the role heuristics look for."""
    def frames(rng, rels):
        return {f"{take}_{i:06d}_{split}": [list(r) for r in rels] for i in rng}

    base = [("Patient", "LyingOn", "operating_table"), ("human_2", "Operating", "anesthesia_equipment"),
            ("human_3", "CloseTo", "secondary_table")]
    sgs = frames(range(0, 10), [("human_3", "CloseTo", "instrument_table")])
    sgs.update(frames(range(10, 20), base + [("human_2", "Operating", "operating_table")]))
    sgs.update(frames(range(20, 30), base + [("human_0", "Preparing", "Patient"), ("human_1", "Preparing", "Patient")]))
    sgs.update(frames(range(30, 40), base + [("human_0", "Cleaning", "Patient"), ("human_1", "Assisting", "human_0")]))
    sgs.update(frames(range(40, 50), base + [("human_0", "Cutting", "Patient")]))
    sgs.update(frames(range(50, 60), base + [("human_0", "Sawing", "Patient"), ("human_1", "Holding", "instrument")]))
    sgs.update(frames(range(66, 76), base + [("human_0", "Hammering", "Patient")]))
    sgs.update(frames(range(76, 86), base + [("human_0", "Cementing", "Patient")]))
    sgs.update(frames(range(86, 96), base + [("human_0", "Suturing", "Patient"), ("human_1", "Touching", "human_0")]))
    sgs.update(frames(range(96, 110), base + [("human_2", "Operating", "operating_table")]))
    sgs.update(frames(range(110, 120), [("human_3", "Touching", "instrument_table"),
                                        ("human_2", "CloseTo", "anesthesia_equipment")]))
    return sgs


def test_roles_phases_and_phases_eval_equal_the_jax_cli(tmp_path, capsys):
    rels = tmp_path / "scan_relations_no_gt_test.json"
    rels.write_text(json.dumps({**_walk(2, 2), **_walk(6, 2)}))
    out = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", cli.main, [])):
        d = tmp_path / side
        d.mkdir()
        assert main(["roles", "--relations", str(rels), "--output", str(d / "roles.json"), *extra]) == 0
        assert main(["phases", "--relations", str(rels), "--roles", str(d / "roles.json"),
                     "--output-dir", str(d / "ph")]) == 0
        capsys.readouterr()
        gt = tmp_path / "gt"
        if not gt.exists():
            gt.mkdir()
            (gt / "phase_to_frames_2.json").write_text(json.dumps(
                {"sterile": [0, 9], "roll_in": [10, 21], "patient_prep": [22, 41], "knee_prep": [42, 67],
                 "knee_insert": [68, 90], "surgery_conclusion": [91, 99], "roll_out": [100, 111],
                 "cleanup": [112, 119]}))
        assert main(["phases-eval", "--gt-dir", str(gt), "--pred-dir", str(d / "ph")]) == 0
        out[side] = capsys.readouterr().out
    roles = json.loads((tmp_path / "port" / "roles.json").read_text())
    assert roles == json.loads((tmp_path / "jax" / "roles.json").read_text())
    assert roles["2_000050"] == {"Patient": "Patient", "human_0": "head_surgeon", "human_1": "assistant_surgeon",
                                 "human_2": "anaesthetist", "human_3": "circulating_nurse"}
    names = sorted(p.name for p in (tmp_path / "jax" / "ph").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port" / "ph").iterdir()) and len(names) == 2
    for name in names:
        phases = json.loads((tmp_path / "port" / "ph" / name).read_text())
        assert phases == json.loads((tmp_path / "jax" / "ph" / name).read_text())
        assert len(phases) == 8, phases
    assert out["port"] == out["jax"] and "Take 2" in out["port"] and "\ntest\n" in out["port"]
