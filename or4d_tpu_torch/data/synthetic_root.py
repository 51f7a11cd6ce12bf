"""A synthetic data root in the 4D-OR release layout, written with the port's
own writers (the layout of ``tests/golden/make_real_fixture.py``, which
writes the JAX package's fixture):

    relationships_{train,validation,test_dummy}.json
    export_holistic_take{T}_processed/pcds/{S}.pcd   (binary; binary_compressed
                                                      every other scan)
    instance_labels/{T}_{S}.npz                      (GT, int8, -1 = background)
    human_name_to_3D_joints/{T}_GT_True.npz
    group_free_predictions/{T}_{S}.npz               (one box per furniture class)
    OR_4D_outputs/pred_{T}_{S}.npy                   ((humans, 14, 3) poses)
    object_scans/{name}/{T}.ply                      (registered furniture scans)
    object_pose_results/{POSE_SUBDIR}/{T}_{S}.npz    ({ply path: 4x4 transform})
    object_pose_results/{POSE_SUBDIR}/{T}_stationary_objects.npz

Clouds are in millimetres at OR-scale coordinates: four furniture objects
(points inside their oriented boxes) and a patient lying on the table with
staff standing around it (points scattered along their limbs), each object
``points_per_object`` points, plus a floor. The Group-Free boxes are the
furniture's true boxes (sizes in metres, as Group-Free writes them, the
heading sign flipped for the two classes whose sign L2 flips back) and the
poses the humans' true skeletons, so the L2 stage's pred labels
(``instance-labels``) resemble the GT labels. The registered object scans
(the furniture's GT geometry, which the Group-Free detection dataset turns
into GT boxes) are points of each furniture box in its own frame, placed by
the scan's pose; the two stationary tables keep their pose of the take's
first scan. Every scan lists the virtual ``instrument`` too. Deterministic
in ``seed``.

:func:`add_camera_frames` gives every take of a root the six cameras'
colour frames and the frames list the image branch reads
(``colorimage/camera0{c}_colorimage-{i}.jpg``,
``timestamp_to_pcd_and_frames_list.json``), copied from a directory of
jpgs; :func:`densify_object_scan` rewrites a registered object scan
(``object_scans/{name}/{take}.ply``) with more points, for clouds over the
8192 points of the single-block FPS kernel.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import DEPTH_SCALING, LIMBS, OBJECT_LABEL_MAP, STATIONARY_OBJECTS, TAKE_SPLIT
from or4d_tpu_torch.data.pcd_io import read_ply, write_pcd

FURNITURE = {  # name: (center, size (l, w, h)) in mm
    "anesthesia_equipment": ((-900.0, 500.0, 900.0), (600.0, 1000.0, 500.0)),
    "operating_table": ((0.0, 400.0, 0.0), (2000.0, 800.0, 700.0)),
    "instrument_table": ((900.0, 450.0, -700.0), (1200.0, 900.0, 600.0)),
    "secondary_table": ((1100.0, 400.0, 900.0), (800.0, 800.0, 600.0)),
}
POSE_SUBDIR = "vs_0.01_rf_0.25_maxnn_500_ft_0.25"  # the L2 loader's default
SCAN_POINTS = 400  # points of a registered object scan (the fixture's size)
_FLIPPED = ("operating_table", "anesthesia_equipment")  # L2 flips their heading sign
_SPLIT_FILE = {"train": "relationships_train.json", "val": "relationships_validation.json",
               "test": "relationships_test_dummy.json"}
# a 14-joint standing pose (IDX_TO_BODY_PART order), y up, feet at y = 0
_POSE = np.array([
    [0, 1700, 0], [0, 1500, 0], [-180, 1450, 0], [180, 1450, 0], [-110, 950, 0], [110, 950, 0],
    [-250, 1150, 60], [250, 1150, 60], [-300, 950, 150], [300, 950, 150], [-110, 500, 20],
    [110, 500, 20], [-110, 60, 0], [110, 60, 0],
], dtype=np.float64)
_STAFF_SITES = np.array([[-700.0, 0.0, -900.0], [600.0, 0.0, -1000.0], [-1200.0, 0.0, 0.0],
                         [1400.0, 0.0, 0.0], [-300.0, 0.0, 1200.0]])
_RELATIONS = [("Patient", "operating_table", "LyingOn"), ("human_0", "Patient", "Cutting"),
              ("human_1", "instrument_table", "CloseTo"), ("human_2", "anesthesia_equipment", "Operating"),
              ("human_3", "human_0", "Assisting"), ("human_0", "instrument", "Holding"),
              ("human_1", "Patient", "Preparing"), ("human_3", "secondary_table", "Touching")]


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _skeleton(rng: np.random.Generator, site: np.ndarray, lying: bool) -> np.ndarray:
    pose = _POSE.copy()
    if lying:  # body axis along x, on the table top
        pose = np.stack([pose[:, 1] - 850.0, np.full(14, 900.0) + pose[:, 2], pose[:, 0]], axis=1)
    else:
        pose = pose @ _rot_y(rng.uniform(0, 2 * np.pi)).T
    return pose + site + rng.normal(scale=10.0, size=(14, 3))


def _limb_points(rng: np.random.Generator, joints: np.ndarray, n: int) -> np.ndarray:
    limb = rng.integers(0, len(LIMBS), n)
    a, b = np.asarray(LIMBS)[limb].T
    t = rng.uniform(0, 1, (n, 1))
    return joints[a] * (1 - t) + joints[b] * t + rng.normal(scale=35.0, size=(n, 3))


def _box_points(rng: np.random.Generator, center, size, heading: float, n: int) -> np.ndarray:
    local = rng.uniform(-0.5, 0.5, (n, 3)) * np.asarray(size)
    return local @ _rot_y(heading).T + np.asarray(center)


def write_scan(root: Path, take: int, scan: str, rng: np.random.Generator, n_staff: int,
               points_per_object: int, floor_points: int, compressed: bool):
    """One scan's pcd, GT labels, Group-Free boxes and poses; returns the
    object names, the GT joints by name and the furniture's 4x4 poses (mm)
    by name."""
    pts, labels, colors = [], [], []
    boxes, classes, furniture = [], [], {}
    for name, (center, size) in FURNITURE.items():
        center = np.asarray(center) + rng.normal(scale=20.0, size=3) * [1, 0, 1]
        heading = float(rng.uniform(-0.3, 0.3))
        pts.append(_box_points(rng, center, size, heading, points_per_object))
        labels.append(np.full(points_per_object, OBJECT_LABEL_MAP[name]))
        colors.append(np.broadcast_to(rng.uniform(0.2, 0.9, 3), (points_per_object, 3)))
        furniture[name] = np.eye(4)
        furniture[name][:3, :3], furniture[name][:3, 3] = _rot_y(heading), center
        h = -heading if name in _FLIPPED else heading
        boxes.append(np.r_[center / 1000.0, np.asarray(size) / 1000.0, h])
        classes.append(OBJECT_LABEL_MAP[name])
    joints = {"Patient": _skeleton(rng, np.zeros(3), lying=True)}
    for i in range(n_staff):
        joints[f"human_{i}"] = _skeleton(rng, _STAFF_SITES[i % len(_STAFF_SITES)], lying=False)
    for name, j in joints.items():
        pts.append(_limb_points(rng, j, points_per_object))
        labels.append(np.full(points_per_object, OBJECT_LABEL_MAP[name]))
        colors.append(np.broadcast_to(rng.uniform(0.4, 1.0, 3), (points_per_object, 3)))
    floor = np.stack([rng.uniform(-2500, 2500, floor_points), rng.uniform(-30, 0, floor_points),
                      rng.uniform(-2500, 2500, floor_points)], axis=1)
    pts.append(floor)
    labels.append(np.full(floor_points, -1))
    colors.append(rng.uniform(0.3, 0.6, (floor_points, 3)))
    order = rng.permutation(sum(len(p) for p in pts))
    xyz = np.concatenate(pts)[order].astype(np.float32)
    gt = np.concatenate(labels)[order].astype(np.int8)
    rgb = np.clip(np.concatenate(colors)[order], 0, 1).astype(np.float32)

    pcd_dir = root / f"export_holistic_take{take}_processed" / "pcds"
    pcd_dir.mkdir(parents=True, exist_ok=True)
    write_pcd(pcd_dir / f"{scan}.pcd", np.concatenate([xyz, rgb], axis=1), compressed=compressed)
    np.savez_compressed(root / "instance_labels" / f"{take}_{scan}.npz", gt)
    np.savez_compressed(root / "group_free_predictions" / f"{take}_{scan}.npz", {
        "classes_nms": np.asarray(classes), "bboxes_nms": np.stack(boxes),
        "scores_nms": rng.uniform(0.5, 1.0, len(classes))})
    np.save(root / "OR_4D_outputs" / f"pred_{take}_{scan}.npy", np.stack(list(joints.values())))
    return list(FURNITURE) + list(joints) + ["instrument"], joints, furniture


def _scan_key(name: str, take: int) -> str:
    return f"datasets/4D-OR/object_scans/{name}/{take}.ply"


def _registered(pose: np.ndarray) -> np.ndarray:
    """A pose (mm) as the release stores it: translation in depth units."""
    t = pose.copy()
    t[:3, 3] /= DEPTH_SCALING
    return t


def write_object_scans(root: Path, take: int, poses_by_scan: dict, rng: np.random.Generator) -> None:
    """The take's registered furniture scans (``SCAN_POINTS`` points of each
    box in its own frame, mm) and their poses: every furniture per scan, the
    stationary tables once per take (from its first scan)."""
    for name, (_center, size) in FURNITURE.items():
        path = root / "object_scans" / name / f"{take}.ply"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_ply(path, _box_points(rng, np.zeros(3), size, 0.0, SCAN_POINTS).astype(np.float32))
    poses_dir = root / "object_pose_results" / POSE_SUBDIR
    poses_dir.mkdir(parents=True, exist_ok=True)
    for scan, poses in poses_by_scan.items():
        np.savez_compressed(poses_dir / f"{take}_{scan}.npz",
                            {_scan_key(n, take): _registered(p) for n, p in poses.items()})
    first = poses_by_scan[min(poses_by_scan)]
    stationary = np.empty((len(STATIONARY_OBJECTS), 2), dtype=object)
    for i, name in enumerate(STATIONARY_OBJECTS):
        stationary[i] = [_scan_key(name, take), _registered(first[name])]
    np.savez_compressed(poses_dir / f"{take}_stationary_objects.npz", stationary)


def write_data_root(root, seed: int = 0, scans_per_take: int = 2, n_staff: int = 4,
                    points_per_object: int = 2000, floor_points: int = 2000) -> dict:
    """Write the data root (every take of every split); returns
    {"scans": {split: n}, "points_per_scan": n, "compressed": n}."""
    root = Path(root)
    for sub in ("instance_labels", "group_free_predictions", "OR_4D_outputs", "human_name_to_3D_joints"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    scan_rng = np.random.default_rng([seed, 1])  # the registered scans' own draws
    counts, compressed = {}, 0
    for split, takes in TAKE_SPLIT.items():
        scans = []
        for take in takes:
            joints_by_scan, poses_by_scan = {}, {}
            for i in range(scans_per_take):
                scan = f"{i:06d}"
                squeeze = (sum(counts.values()) + len(scans)) % 2 == 1
                names, joints, poses_by_scan[scan] = write_scan(root, take, scan, rng, n_staff, points_per_object,
                                                                floor_points, compressed=squeeze)
                compressed += squeeze
                joints_by_scan[scan] = joints
                objects = {str(k + 1): n for k, n in enumerate(sorted(names))}
                inv = {n: int(k) for k, n in objects.items()}
                rels = [] if split == "test" else [
                    [inv[s], inv[o], j, r] for j, (s, o, r) in enumerate(_RELATIONS)
                    if s in inv and o in inv and rng.uniform() < 0.8]
                humans = {n: "head-surgeon" if n == "human_0" else "assistant-surgeon"
                          for n in names if n.startswith("human")}
                scans.append({"take_idx": take, "scan": scan, "objects": objects, "relationships": rels,
                              "human_idx_to_name": humans})
            np.savez_compressed(root / "human_name_to_3D_joints" / f"{take}_GT_True.npz", joints_by_scan)
            write_object_scans(root, take, poses_by_scan, scan_rng)
        (root / _SPLIT_FILE[split]).write_text(json.dumps({"scans": scans}))
        counts[split] = len(scans)
    return {"scans": counts, "points_per_scan": (4 + 1 + n_staff) * points_per_object + floor_points,
            "compressed": compressed}


def add_camera_frames(root, frames_dir, scans_per_take: int = 2) -> int:
    """Copy the jpgs of ``frames_dir`` (``camera0{c}_colorimage-{i}.jpg``)
    into every take of ``root`` and write each take's frames list: scan k
    (pcd index k) takes the k-th frame index found, cyclically. Returns the
    number of takes."""
    import shutil

    frames_dir = Path(frames_dir)
    indices = sorted({p.stem.split("-")[-1] for p in frames_dir.glob("camera01_colorimage-*.jpg")})
    takes = sorted(int(p.name[len("export_holistic_take"):-len("_processed")])
                   for p in Path(root).glob("export_holistic_take*_processed"))
    for take in takes:
        tdir = Path(root) / f"export_holistic_take{take}_processed"
        (tdir / "colorimage").mkdir(exist_ok=True)
        for jpg in frames_dir.glob("camera0*_colorimage-*.jpg"):
            shutil.copyfile(jpg, tdir / "colorimage" / jpg.name)
        entries = [[f"ts_{k:06d}", {"pcd": f"{k:06d}", **{f"color_{c}": indices[k % len(indices)]
                                                          for c in range(1, 7)}}] for k in range(scans_per_take)]
        (tdir / "timestamp_to_pcd_and_frames_list.json").write_text(json.dumps(entries))
    return len(takes)


def write_ply(path, xyz: np.ndarray) -> None:
    """A binary little-endian PLY of (N, 3) float32 vertices, as the
    release's registered object scans are."""
    xyz = np.ascontiguousarray(xyz, "<f4")
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(xyz)}\nproperty float x\n"
              "property float y\nproperty float z\nend_header\n")
    Path(path).write_bytes(header.encode("ascii") + xyz.tobytes())


def densify_object_scan(root, name: str, take: int, n_points: int, seed: int = 0) -> int:
    """Rewrite ``object_scans/{name}/{take}.ply`` with ``n_points`` points:
    the scan's own points, then copies of them moved by 0.5% of the scan's
    extent (deterministic in ``seed``). Returns the old point count."""
    path = Path(root) / "object_scans" / name / f"{take}.ply"
    xyz = read_ply(path)[:, :3]
    rng = np.random.default_rng(seed)
    extra = xyz[rng.integers(0, len(xyz), n_points - len(xyz))]
    extra = extra + rng.normal(scale=0.005 * float(np.ptp(xyz, axis=0).max()), size=extra.shape)
    write_ply(path, np.concatenate([xyz, extra]).astype(np.float32))
    return len(xyz)
