"""L2: pose -> per-point instance labels (port of
``or4d_tpu/pipeline/instance_labels.py``).

Reference: `compute_instance_labels.py` — per scan, project object boxes and
human skeletons onto the fused 6-Kinect cloud:

  * predicted path: one Group-Free box per class (best score), sizes *1000,
    heading sign flipped for operating_table / anesthesia_equipment
    (:158-184); box -> 20^3 grid point cloud (convert_oriented_box_to_pose
    :48-64);
  * per object: bbox prefilter -> FPS to 200 pts -> min distance < 75 ->
    label overwrite in object order (:186-200);
  * humans: skeleton -> limb-cylinder point cloud (radius 30), bbox grown by
    100 with an extra 100 along the head axis, a virtual edge point past the
    head, threshold 75 (compute_human_instance_labels :67-122);
  * hand exception: around the wrists (+-100 box), threshold 150, may
    overwrite background and the three table classes only (:108-120,
    :231-239);
  * outputs: instance_labels npz (int8) + human_name_to_3D_joints.

FPS runs through ``ops.fps.furthest_point_sample``: on the card the
``fps.cu`` kernel (the port of TPU row 2), one launch for all of a scan's
object clouds of one size (the box grids share 8000 points) and one per
skeleton; on the CPU its plain version. The kernel takes at most 8192 points
a cloud and raises beyond. The distance test (:func:`close_mask`) is plain
PyTorch on both devices: the f32 ``|a|^2 + |b|^2 - 2ab`` expansion of the
JAX package's ``pairwise_sqdist``, with TF32 off for the product.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import numpy as np
import torch

from or4d_tpu_torch.config import IDX_TO_BODY_PART, LIMBS, OBJECT_LABEL_MAP, STATIONARY_OBJECTS
from or4d_tpu_torch.data.pcd_io import coord_transform_pose_tool_to_or4d, load_registered_object_scan, read_pcd
from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.ops.fps import furthest_point_sample

NPOINTS = 200  # compute_instance_labels.py:21
CLOSENESS_THRESHOLD = 75.0  # :22
_MASK_ROWS = 1 << 18  # points per distance block: (rows, 201) float32 = 200 MB


def heading_to_rotmat(angle: float) -> np.ndarray:
    """Rotation about +y (heading2rotmat :37-46)."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def oriented_box_to_grid(box: np.ndarray) -> np.ndarray:
    """Oriented box (cx,cy,cz,l,w,h,heading) -> 20^3 grid point cloud
    (convert_oriented_box_to_pose :48-64; note the meshgrid x/y swap is
    immaterial for the downstream distance tests)."""
    ctr, lengths, heading = box[:3], box[3:6], box[6]
    g = [np.linspace(-lengths[i] / 2, lengths[i] / 2, 20) for i in range(3)]
    gx, gy, gz = np.meshgrid(*g)
    pts = np.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], axis=1)
    return pts @ heading_to_rotmat(heading).T + ctr


def skeleton_to_limb_points(joints: np.ndarray, radius: float = 30.0, segments: int = 16, rings_per_unit: float = 0.05) -> np.ndarray:
    """Skeleton -> limb-cylinder surface points (human_pose_to_joints /
    linemesh rebuild: one cylinder of the given radius per limb): 16 points
    a ring, a ring every 20 units of limb length (at least 2 a limb). A
    skeleton whose limbs all have zero length has no points: (0, 3)."""
    pts = []
    for a, b in LIMBS:
        p0, p1 = joints[a], joints[b]
        axis = p1 - p0
        length = np.linalg.norm(axis)
        if length < 1e-6:
            continue
        axis = axis / length
        # orthonormal frame around the limb axis
        ref = np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        u = np.cross(axis, ref)
        u /= np.linalg.norm(u)
        v = np.cross(axis, u)
        n_rings = max(2, int(length * rings_per_unit))
        ts = np.linspace(0, length, n_rings)
        angs = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        ring = np.outer(np.cos(angs), u) + np.outer(np.sin(angs), v)
        for t in ts:
            pts.append(p0 + axis * t + ring * radius)
    return np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _sqnorm(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]


def close_mask(points: torch.Tensor, samples: torch.Tensor, bbox: torch.Tensor, threshold: float) -> torch.Tensor:
    """points (N, 3), samples (K, 3), bbox (2, 3), all float32 on one device
    -> bool (N,): inside bbox AND min squared distance to the samples below
    threshold^2 (``_close_mask`` of the JAX package, an XLA op there too)."""
    inside = ((points >= bbox[0]) & (points <= bbox[1])).all(dim=1)
    b2 = _sqnorm(samples)[None, :]
    close = torch.empty_like(inside)
    with _no_tf32():
        for i in range(0, len(points), _MASK_ROWS):
            p = points[i : i + _MASK_ROWS]
            d2 = torch.clamp_min(_sqnorm(p)[:, None] + b2 - 2.0 * (p @ samples.T), 0.0)
            close[i : i + _MASK_ROWS] = d2.min(dim=1).values < threshold * threshold
    return inside & close


def fps_samples(clouds: list[np.ndarray], n: int, device: torch.device) -> list[np.ndarray]:
    """FPS ``n`` points of each (N_i, 3) cloud (float32 coordinates, the
    points returned as given): clouds of equal N share one kernel launch."""
    out: list[np.ndarray | None] = [None] * len(clouds)
    by_n: dict[int, list[int]] = {}
    for i, c in enumerate(clouds):
        by_n.setdefault(len(c), []).append(i)
    for members in by_n.values():
        xyz = torch.from_numpy(np.stack([np.asarray(clouds[i], np.float32) for i in members])).to(device)
        idx = furthest_point_sample(xyz, n).cpu().numpy()
        for row, i in enumerate(members):
            out[i] = clouds[i][idx[row]]
    return out


def select_best_boxes(classes: np.ndarray, boxes: np.ndarray, scores: np.ndarray):
    """One box per class by best score; sizes *1000; heading sign fix for
    operating_table / anesthesia_equipment (:158-184)."""
    label_to_name = {v: k for k, v in OBJECT_LABEL_MAP.items()}
    out = []
    for cls in np.unique(classes):
        m = classes == cls
        best = boxes[m][scores[m].argmax()].astype(np.float64).copy()
        best[:6] *= 1000.0
        name = label_to_name[int(cls)]
        if name in ("operating_table", "anesthesia_equipment"):
            best[6] *= -1
        out.append((name, best))
    return out


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def label_objects(points: torch.Tensor, objects: list[tuple[str, np.ndarray]], instance_labels: np.ndarray) -> np.ndarray:
    """Project object clouds onto the scan (``points`` (N, 3) float32 on the
    device), overwriting in object order."""
    dev = points.device
    samples = fps_samples([grid for _name, grid in objects], NPOINTS, dev)
    for (name, grid), sam in zip(objects, samples):
        bbox = np.stack([grid.min(0), grid.max(0)])
        mask = close_mask(points, _tensor(sam, dev), _tensor(bbox, dev), CLOSENESS_THRESHOLD)
        instance_labels[mask.cpu().numpy()] = OBJECT_LABEL_MAP[name]
    return instance_labels


def human_masks(points: torch.Tensor, joints: np.ndarray):
    """compute_human_instance_labels(:67-122): body mask + hand-exception mask.
    A skeleton collapsed to one point (as an untrained VoxelPose can
    predict) has no limb surface and masks nothing."""
    dev = points.device
    limb_pts = skeleton_to_limb_points(joints, radius=30.0)
    if not len(limb_pts):
        none = np.zeros(points.shape[0], bool)
        return none, none.copy()
    head = joints[0]
    feet_center = np.mean([joints[12], joints[13]], axis=0)
    main_axis = int(np.abs(head - feet_center).argmax())
    positive = (head - feet_center)[main_axis] > 0

    mn = limb_pts.min(0) - 100.0
    mx = limb_pts.max(0) + 100.0
    if positive:
        mx[main_axis] += 100.0
    else:
        mn[main_axis] -= 100.0

    samples = fps_samples([limb_pts], NPOINTS, dev)[0]
    # virtual point past the head along the body axis (:97-103)
    if positive:
        edge = samples[samples[:, main_axis].argmax()].copy()
        edge[main_axis] += 100.0
    else:
        edge = samples[samples[:, main_axis].argmin()].copy()
        edge[main_axis] -= 100.0
    sam = _tensor(np.concatenate([samples, edge[None]], axis=0), dev)
    body = close_mask(points, sam, _tensor(np.stack([mn, mx]), dev), CLOSENESS_THRESHOLD).cpu().numpy()

    wrists = np.stack([joints[IDX_TO_BODY_PART.index("leftwrist")], joints[IDX_TO_BODY_PART.index("rightwrist")]])
    hb = np.stack([wrists.min(0) - 100.0, wrists.max(0) + 100.0])
    hands = close_mask(points, sam, _tensor(hb, dev), CLOSENESS_THRESHOLD * 2).cpu().numpy()
    return body, hands


_HAND_OVERWRITABLE = (-1, OBJECT_LABEL_MAP["instrument_table"], OBJECT_LABEL_MAP["secondary_table"], OBJECT_LABEL_MAP["operating_table"])


def label_humans(points: torch.Tensor, human_poses: dict[str, np.ndarray], instance_labels: np.ndarray) -> np.ndarray:
    """Apply body masks + the hand exception (overwrites background and the
    three table classes near the wrists, :231-239)."""
    for h_name, joints in human_poses.items():
        body, hands = human_masks(points, np.asarray(joints, np.float64))
        instance_labels[body] = OBJECT_LABEL_MAP[h_name]
        overwritable = np.isin(instance_labels, _HAND_OVERWRITABLE)
        instance_labels[hands & overwritable] = OBJECT_LABEL_MAP[h_name]
    return instance_labels


def load_gt_objects(root, take_idx, pcd_idx: str, pose_subdir: str = "vs_0.01_rf_0.25_maxnn_500_ft_0.25"):
    """GT-object path (compute_instance_labels.py:139-156): registered object
    scans (per-scan npz of {ply_path: 4x4 transform}) merged with the take's
    stationary objects, minus the manual json's false_objects; each entry
    becomes (name, transformed scan points).

    Paths inside the npz are reference-release relative
    ('datasets/4D-OR/object_scans/{name}/{take}.ply'); they are re-rooted
    onto ``root``/object_scans.
    """
    root = Path(root)
    poses_dir = root / "object_pose_results" / pose_subdir
    registered = np.load(str(poses_dir / f"{take_idx}_{pcd_idx}.npz"), allow_pickle=True)["arr_0"].item()
    stationary = {k: v for k, v in np.load(str(poses_dir / f"{take_idx}_stationary_objects.npz"),
                                           allow_pickle=True)["arr_0"]}
    # faithful take-10 quirk: string comparison includes the '.pcd' suffix,
    # so the nudge applies from scan 000198 onward (:146-147)
    if f"{pcd_idx}.pcd" > "000198" and int(take_idx) == 10:
        key = next((k for k in stationary if "secondary_table" in k), None)
        if key is not None:
            stationary[key] = np.array(stationary[key], np.float64)
            stationary[key][:3, 3] += [-0.05, 0, -0.05]
    registered = {k: v for k, v in registered.items() if k.split("/")[3] not in STATIONARY_OBJECTS}
    registered = {**registered, **stationary}

    false_objects: set = set()
    manual = poses_dir / f"{take_idx}_{pcd_idx}_manual.json"
    if manual.exists():
        false_objects = set(json.loads(manual.read_text()).get("false_objects", []))

    objects = []
    for path_str, transform in registered.items():
        name = path_str.split("/")[3]
        if name in false_objects:
            continue
        ply = root / "object_scans" / name / Path(path_str).name
        pts = load_registered_object_scan(ply, np.array(transform, np.float64))
        objects.append((name, pts[:, :3]))
    return objects


def load_gt_humans(root, take_idx, pcd_idx: str) -> dict[str, np.ndarray]:
    """GT-human path (compute_instance_labels.py:205-230): the annotation
    json's per-joint labels -> 14-joint poses in the OR-4D frame; humans are
    renamed human_0.. in sorted humanName order, Patient keeps its name."""
    p = Path(root) / f"export_holistic_take{take_idx}_processed" / "annotations" / f"{pcd_idx}.json"
    out: dict[str, np.ndarray] = {}
    if not p.exists():
        return out
    labels = json.loads(p.read_text())["labels"]
    h_idx = 0
    for human_name in sorted({e["humanName"] for e in labels}):
        joint_pos = {}
        for e in labels:
            if e["humanName"] == human_name:
                loc = e["point3d"]["location"]
                joint_pos[e["jointName"]] = (loc["x"], loc["y"], loc["z"])
        pose = np.asarray([joint_pos[bp] for bp in IDX_TO_BODY_PART], np.float64)
        pose = coord_transform_pose_tool_to_or4d(pose)
        if human_name == "Patient":
            out["Patient"] = pose
        else:
            out[f"human_{h_idx}"] = pose
            h_idx += 1
    return out


def load_boxes_npz(path: str | Path) -> dict:
    """Read a group_free_predictions npz (compute_instance_labels.py:159)."""
    return np.load(path, allow_pickle=True)["arr_0"].item()


def boxes_from_npz(path: Path) -> dict | None:
    """{'classes', 'bboxes', 'scores'} of the NMS'd Group-Free boxes, or None
    when the file is absent."""
    if not path.exists():
        return None
    loaded = load_boxes_npz(path)
    return {"classes": loaded["classes_nms"], "bboxes": loaded["bboxes_nms"], "scores": loaded["scores_nms"]}


def poses_from_npy(path: Path) -> dict[str, np.ndarray]:
    """{human_{i}: (14, 3)} from a VoxelPose ``pred_{take}_{frame}.npy``;
    {} when the file is absent."""
    return {f"human_{h}": pose for h, pose in enumerate(np.load(str(path)))} if path.exists() else {}


def process_take(root, take_idx, from_gt: bool = False, out_root=None,
                 boxes_dir=None, poses_dir=None, device=None) -> int:
    """Per-take L2 run (_process_take_helper :125-266): label every scan
    of the take and write the two artifacts the downstream layers consume —
    instance_labels{,_pred}/{take}_{scan}.npz and
    human_name_to_3D_joints/{take}_GT_{from_gt}.npz. Runs on ``device``
    (default the card; raises without one unless given ``"cpu"``)."""
    device = resolve_device(device)
    root = Path(root)
    out_root = Path(out_root) if out_root else root
    label_dir = out_root / ("instance_labels" if from_gt else "instance_labels_pred")
    label_dir.mkdir(parents=True, exist_ok=True)
    joints_dir = out_root / "human_name_to_3D_joints"
    joints_dir.mkdir(parents=True, exist_ok=True)

    pcd_paths = sorted((root / f"export_holistic_take{take_idx}_processed" / "pcds").glob("*.pcd"))
    all_joints: dict[str, dict] = {}
    count = 0
    for pcd_path in pcd_paths:
        pcd_idx = pcd_path.stem
        points = read_pcd(pcd_path)[:, :3]
        if from_gt:
            objects = load_gt_objects(root, take_idx, pcd_idx)
            human_poses = load_gt_humans(root, take_idx, pcd_idx)
            boxes = None
        else:
            objects = None
            boxes = boxes_from_npz(Path(boxes_dir or (root / "group_free_predictions")) / f"{take_idx}_{pcd_idx}.npz")
            human_poses = poses_from_npy(Path(poses_dir or (root / "OR_4D_outputs")) / f"pred_{take_idx}_{pcd_idx}.npy")
        labels = compute_instance_labels_for_scan(points, boxes=boxes, human_poses=human_poses, objects=objects,
                                                  device=device)
        np.savez_compressed(str(label_dir / f"{take_idx}_{pcd_idx}.npz"), labels)
        all_joints[pcd_idx] = human_poses
        count += 1
    np.savez_compressed(str(joints_dir / f"{take_idx}_GT_{from_gt}.npz"), all_joints)
    return count


def compute_instance_labels_for_scan(
    points: np.ndarray,
    boxes: dict | None = None,
    human_poses: dict[str, np.ndarray] | None = None,
    objects: list[tuple[str, np.ndarray]] | None = None,
    device=None,
) -> np.ndarray:
    """Full per-scan path: (predicted boxes | prebuilt object clouds) then
    humans. ``boxes``: {'classes': (K,), 'bboxes': (K, 7), 'scores': (K,)}.
    Returns int8 labels (N,), -1 = background. Runs on ``device`` (default
    the card; raises without one unless given ``"cpu"``)."""
    device = resolve_device(device)
    labels = np.full(len(points), -1, np.int8)
    if objects is None and boxes is not None:
        objects = [(name, oriented_box_to_grid(b)) for name, b in select_best_boxes(boxes["classes"], boxes["bboxes"], boxes["scores"])]
    if not objects and not human_poses:
        return labels
    pts = _tensor(points, device)
    if objects:
        labels = label_objects(pts, objects, labels)
    if human_poses:
        labels = label_humans(pts, human_poses, labels)
    return labels
