"""Real 4D-OR dataset ingest — the load_mesh rebuild (port of
``or4d_tpu/data/ingest.py``; every random draw comes from the
``np.random.Generator`` passed in, as there).

Reference: `scene_graph_helpers/dataset/dataset_utils.py`:
  * `load_mesh` (:65-117): read the fused 6-Kinect pcd, load per-point
    instance labels (GT or predicted), remap dataset-wide OBJECT_LABEL_MAP
    indices to scan-local instance keys, add a **virtual instrument box** at
    fixed coordinates (50-unit cube at [-200, 1056, -66], 1000 surface
    points, color [0.9, 0.1, 0.1]) and an **emulated cone** for every object
    named in the GT but absent from the scan (radius-50 / height-2 cone at
    [600, 1056, -66], color [0.9, 0.9, 0.1]);
  * `match_human_labels_to_gt` (:134-181): greedy one-directional-chamfer
    matching of predicted human blobs onto GT human labels (pred labels are
    re-written to the matched GT identity; leftovers take free identities);
  * `compute_dist_matrix_between_human_pcds` (:120-131): mean
    nearest-neighbour distance on 1000-point random subsets;
  * `dataset_loading` (:52-61): for inference without GT, the per-scan object
    list is synthesized from the predicted instance labels (+ 'instrument');
  * hand locations: wrist joints (indices 8:10 of the 14-joint skeleton) from
    `human_name_to_3D_joints/{take}_GT_True.npz` (or_dataset.py:83-91,
    load_mesh :89-90).

Directory layout mirrors helpers/configurations.py:48-61 relative to the
dataset root:
    export_holistic_take{T}_processed/pcds/{S}.pcd
    instance_labels/{T}_{S}.npz            (GT, int8, -1 = background)
    instance_labels_pred/{T}_{S}.npz       (predicted)
    human_name_to_3D_joints/{T}_GT_{bool}.npz
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import OBJECT_LABEL_MAP
from or4d_tpu_torch.data import pcd_io

HUMAN_NAMES = ["Patient", "human_0", "human_1", "human_2", "human_3", "human_4", "human_5", "human_6"]

# virtual-object constants (dataset_utils.py:96-115)
INSTRUMENT_BOX_SIZE = 50.0
INSTRUMENT_BOX_TRANSLATE = np.array([-200.0, 1056.0, -66.0])
INSTRUMENT_COLOR = np.array([0.9, 0.1, 0.1])
CONE_RADIUS = 50.0
CONE_HEIGHT = 2.0  # open3d create_cone default height
CONE_TRANSLATE = np.array([600.0, 1056.0, -66.0])
CONE_COLOR = np.array([0.9, 0.9, 0.1])
VIRTUAL_POINTS = 1000
CHAMFER_DOWNSAMPLE = 1000  # compute_dist_matrix_between_human_pcds


# ---------------------------------------------------------------------------
# path layout
# ---------------------------------------------------------------------------

def pcd_path(root: str | Path, take_idx: int | str, pcd_idx: str) -> Path:
    return Path(root) / f"export_holistic_take{take_idx}_processed" / "pcds" / f"{pcd_idx}.pcd"


def instance_labels_path(root: str | Path, take_idx: int | str, pcd_idx: str, pred: bool = False) -> Path:
    sub = "instance_labels_pred" if pred else "instance_labels"
    return Path(root) / sub / f"{take_idx}_{pcd_idx}.npz"


def human_joints_path(root: str | Path, take_idx: int | str, from_gt: bool = True) -> Path:
    return Path(root) / "human_name_to_3D_joints" / f"{take_idx}_GT_{from_gt}.npz"


def has_raw_scan(root: str | Path, take_idx: int | str, pcd_idx: str, use_gt: bool) -> bool:
    """True when the capture + label files this config needs are on disk."""
    if not pcd_path(root, take_idx, pcd_idx).exists():
        return False
    if not instance_labels_path(root, take_idx, pcd_idx, pred=False).exists():
        return False
    if not use_gt and not instance_labels_path(root, take_idx, pcd_idx, pred=True).exists():
        return False
    return True


def load_human_joints(root: str | Path, take_idx: int | str, from_gt: bool = True) -> dict | None:
    """{pcd_idx: {human_name: (14, 3) joints}} or None when absent
    (or_dataset.py:83-91; test split passes None)."""
    p = human_joints_path(root, take_idx, from_gt)
    if not p.exists():
        return None
    return np.load(str(p), allow_pickle=True)["arr_0"].item()


# ---------------------------------------------------------------------------
# virtual-object surface sampling (open3d sample_points_uniformly equivalent)
# ---------------------------------------------------------------------------

def sample_box_surface(rng: np.random.Generator, size: float = INSTRUMENT_BOX_SIZE,
                       translate: np.ndarray = INSTRUMENT_BOX_TRANSLATE, n: int = VIRTUAL_POINTS) -> np.ndarray:
    """Uniform surface samples of an axis-aligned cube with its min corner at
    ``translate`` (open3d create_box spans [0, size]^3 before translate)."""
    face = rng.integers(0, 6, size=n)          # all 6 faces have equal area
    uv = rng.uniform(0.0, size, size=(n, 2))
    pts = np.empty((n, 3))
    axis = face % 3                            # which coordinate is pinned
    hi = face >= 3                             # pinned to 0 or to size
    for a in range(3):
        sel = axis == a
        others = [d for d in range(3) if d != a]
        pts[sel, a] = np.where(hi[sel], size, 0.0)
        pts[sel, others[0]] = uv[sel, 0]
        pts[sel, others[1]] = uv[sel, 1]
    return pts + translate


def sample_cone_surface(rng: np.random.Generator, radius: float = CONE_RADIUS, height: float = CONE_HEIGHT,
                        translate: np.ndarray = CONE_TRANSLATE, n: int = VIRTUAL_POINTS) -> np.ndarray:
    """Uniform surface samples of a cone with base-circle center at
    ``translate`` and apex at +z*height (open3d create_cone geometry)."""
    slant = np.sqrt(radius * radius + height * height)
    base_area = np.pi * radius * radius
    lateral_area = np.pi * radius * slant
    on_base = rng.uniform(0, base_area + lateral_area, size=n) < base_area
    r_base = radius * np.sqrt(rng.uniform(0, 1, size=n))      # uniform in disk
    r_lat = radius * np.sqrt(rng.uniform(0, 1, size=n))       # area-uniform along slant
    theta = rng.uniform(0, 2 * np.pi, size=n)
    r = np.where(on_base, r_base, r_lat)
    z = np.where(on_base, 0.0, height * (1.0 - r_lat / radius))
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)
    return pts + translate


# ---------------------------------------------------------------------------
# human GT <-> pred matching (dataset_utils.py:120-181)
# ---------------------------------------------------------------------------

def chamfer_dist_matrix(gt_humans: list, pred_humans: list, rng: np.random.Generator,
                        downsample: int = CHAMFER_DOWNSAMPLE) -> np.ndarray:
    """Mean nearest-neighbour distance from each GT blob to each pred blob on
    random ``downsample``-point subsets (one-directional chamfer, matching
    open3d compute_point_cloud_distance(gt -> pred))."""
    dist = np.zeros((len(gt_humans), len(pred_humans)))
    for i, (_, gt_pts) in enumerate(gt_humans):
        gi = rng.choice(len(gt_pts), downsample, replace=len(gt_pts) < downsample)
        g = gt_pts[gi]
        for j, (_, pr_pts) in enumerate(pred_humans):
            pj = rng.choice(len(pr_pts), downsample, replace=len(pr_pts) < downsample)
            p = pr_pts[pj]
            d2 = ((g[:, None, :] - p[None, :, :]) ** 2).sum(-1)
            dist[i, j] = np.sqrt(d2.min(axis=1)).mean()
    return dist


def match_human_labels_to_gt(xyz: np.ndarray, instance_labels_gt: np.ndarray,
                             instance_labels_pred: np.ndarray,
                             rng: np.random.Generator | None = None) -> np.ndarray:
    """Re-identify predicted human labels against GT identities by greedily
    pairing the globally closest (GT, pred) blobs; unmatched pred blobs take
    the free human identities (dataset_utils.py:134-181)."""
    rng = rng or np.random.default_rng(0)
    gt_humans, pred_humans = [], []
    for name in HUMAN_NAMES:
        idx = OBJECT_LABEL_MAP[name]
        if np.sum(instance_labels_gt == idx) > 0:
            gt_humans.append((idx, xyz[instance_labels_gt == idx]))
        if np.sum(instance_labels_pred == idx) > 0:
            pred_humans.append((idx, xyz[instance_labels_pred == idx]))

    matches = []
    gt_pool, pred_pool = list(gt_humans), list(pred_humans)
    while gt_pool and pred_pool:
        dist = chamfer_dist_matrix(gt_pool, pred_pool, rng)
        gi, pj = np.unravel_index(dist.argmin(), dist.shape)
        matches.append((gt_pool[gi][0], pred_pool[pj][0]))
        gt_pool.pop(gi)
        pred_pool.pop(pj)

    out = instance_labels_pred.copy()
    for name in HUMAN_NAMES:
        out[out == OBJECT_LABEL_MAP[name]] = -1
    for gt_label, pred_label in matches:
        out[instance_labels_pred == pred_label] = gt_label

    used = {m[0] for m in matches}
    # leftovers: the reference assigns EVERY free identity in order, so the
    # last free name wins per leftover blob — faithful quirk
    for pred_label, _ in pred_pool:
        for name in HUMAN_NAMES:
            cand = OBJECT_LABEL_MAP[name]
            if cand not in used:
                out[instance_labels_pred == pred_label] = cand
    return out


# ---------------------------------------------------------------------------
# load_mesh
# ---------------------------------------------------------------------------

def load_scan_geometry(
    root: str | Path,
    take_idx: int | str,
    pcd_idx: str,
    objs: dict[int, str],
    use_gt: bool = True,
    for_infer: bool = False,
    human_joints: dict | None = None,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray, dict[int, np.ndarray]]:
    """load_mesh(:65-117): returns (points (N,6) xyz+rgb01, instances (N,)
    scan-local keys with -1 background, hand_locations {key: (2,3) wrists})."""
    rng = rng or np.random.default_rng(int(take_idx) * 1_000_003 + int(pcd_idx))
    points = pcd_io.read_pcd(pcd_path(root, take_idx, pcd_idx))

    gt_labels = np.load(str(instance_labels_path(root, take_idx, pcd_idx, pred=False)))["arr_0"]
    if use_gt:
        instance_labels = gt_labels
    else:
        instance_labels = np.load(str(instance_labels_path(root, take_idx, pcd_idx, pred=True)))["arr_0"]
        if not for_infer:
            instance_labels = match_human_labels_to_gt(points[:, :3], gt_labels, instance_labels, rng)

    modified = np.full(len(instance_labels), -1, instance_labels.dtype)
    not_found: dict[int, str] = {}
    hand_locations: dict[int, np.ndarray] = {}
    joints_for_scan = human_joints.get(str(pcd_idx)) if human_joints is not None else None
    for key in sorted(objs):
        name = objs[key]
        label_idx = OBJECT_LABEL_MAP[name]
        if np.sum(instance_labels == label_idx) == 0 and name != "instrument":
            not_found[key] = name
        modified[instance_labels == label_idx] = key
        if joints_for_scan is not None and name in joints_for_scan:
            hand_locations[key] = np.asarray(joints_for_scan[name])[8:10]

    # virtual instrument box — always appended (load_mesh :99-107)
    instrument_key = next(k for k, v in objs.items() if v == "instrument")
    box = sample_box_surface(rng)
    points = np.concatenate([points, _with_color(box, INSTRUMENT_COLOR)], axis=0)
    modified = np.concatenate([modified, np.full(len(box), instrument_key, modified.dtype)])

    for key in not_found:
        cone = sample_cone_surface(rng)
        points = np.concatenate([points, _with_color(cone, CONE_COLOR)], axis=0)
        modified = np.concatenate([modified, np.full(len(cone), key, modified.dtype)])

    return points.astype(np.float32), modified.astype(np.int32), hand_locations


def _with_color(xyz: np.ndarray, color: np.ndarray) -> np.ndarray:
    return np.concatenate([xyz, np.broadcast_to(color, (len(xyz), 3))], axis=1).astype(np.float32)


def synthesize_objects_from_pred_labels(root: str | Path, take_idx: int | str, pcd_idx: str) -> dict[int, str]:
    """dataset_loading(:52-61): for inference without GT the object list is
    the set of predicted instance labels (+ 'instrument'), sorted by name and
    keyed 1..n."""
    labels = np.load(str(instance_labels_path(root, take_idx, pcd_idx, pred=True)))["arr_0"]
    label_to_name = {v: k for k, v in OBJECT_LABEL_MAP.items()}
    names = [label_to_name[int(l)] for l in np.unique(labels) if l >= 0]
    names.append("instrument")
    return {i + 1: n for i, n in enumerate(sorted(names))}
