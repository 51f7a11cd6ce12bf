"""VoxelPose OR_4D dataset — multi-view db builder + heatmap generators
(port of ``or4d_tpu/data/voxelpose_dataset.py``; numpy, equal to it).

Reference: `external_src/voxelpose/voxelpose_lib/dataset/OR_4D.py:76-341`
(db assembly: pose-tool annotation jsons -> OR_4D frame, per-camera
projection with the /500 world scale + y/z camera flip, camera jsons read
once from the FIRST take — the rig is fixed), `JointsDataset.py:100-380`
(adaptive-sigma gaussian target/input heatmaps, 3D root-gaussian target,
fixed max_people padding) and `configs/4d_or/config.yaml` (image 2048x1536,
heatmap 200x152, sigma 3, ROOTIDX [5, 4], PATIENT_WEIGHT 4, space
8000^3 @ (296.1, 826.0, -190.4), cube 80^3).

Because NETWORK.IMAGE_SIZE equals the native image size and rotation is
always 0 for OR_4D, the reference's affine-transform stage is the identity
and is folded away here; joints_2d are emitted at image scale and heatmaps
at heatmap scale directly.

Emitted samples are fixed-shape dicts that feed
`train.perception_trainers.VoxelPoseTrainer.train_step_from_sample` and the
`models.voxelpose.VoxelPose` projection (heatmaps (C, J, H, W), cameras from
`data.cameras.cam_infos_to_voxelpose`).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import IDX_TO_BODY_PART, TAKE_SPLIT
from or4d_tpu_torch.data.cameras import (
    cam_infos_to_voxelpose,
    coord_transform_pose_tool_to_or4d,
    load_cam_infos,
)

IMAGE_SIZE = (2048.0, 1536.0)  # (w, h)
HEATMAP_SIZE = (200, 152)  # (w, h)
SIGMA = 3.0
ROOT_IDS = (5, 4)  # right hip, left hip (config ROOTIDX)
MAX_PEOPLE = 10
NUM_JOINTS = 14
WORLD_SCALE = 500.0  # project_points_radial_OR_4D divides world coords by 500


def _compute_human_scale(pose_hm: np.ndarray, vis: np.ndarray) -> float:
    """JointsDataset.compute_human_scale (:192-200) at heatmap scale."""
    idx = vis > 0
    if not idx.any():
        return 0.0
    minx, maxx = pose_hm[idx, 0].min(), pose_hm[idx, 0].max()
    miny, maxy = pose_hm[idx, 1].min(), pose_hm[idx, 1].max()
    return float(np.clip(max(maxy - miny, maxx - minx) ** 2, 96.0**2 / 4, 4 * 96.0**2))


def _stamp(target: np.ndarray, mu_x: int, mu_y: int, sigma: float, peak: float, w: int, h: int):
    tmp = sigma * 3
    ul = [int(mu_x - tmp), int(mu_y - tmp)]
    br = [int(mu_x + tmp + 1), int(mu_y + tmp + 1)]
    if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
        return
    size = 2 * tmp + 1
    x = np.arange(0, size, 1, np.float32)
    y = x[:, None]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2)) * peak
    g_x = max(0, -ul[0]), min(br[0], w) - ul[0]
    g_y = max(0, -ul[1]), min(br[1], h) - ul[1]
    i_x = max(0, ul[0]), min(br[0], w)
    i_y = max(0, ul[1]), min(br[1], h)
    target[i_y[0] : i_y[1], i_x[0] : i_x[1]] = np.maximum(
        target[i_y[0] : i_y[1], i_x[0] : i_x[1]], g[g_y[0] : g_y[1], g_x[0] : g_x[1]]
    )


def generate_heatmap(
    joints_2d: np.ndarray,  # (P, J, 2) image-scale
    joints_vis: np.ndarray | None,  # (P, J) for targets; None -> input-heatmap mode
    confidence: np.ndarray | None = None,  # (P, J) peak values (input-heatmap mode)
    sigma: float = SIGMA,
) -> np.ndarray:
    """generate_target_heatmap / generate_input_heatmap (:203-370): per
    person an adaptive sigma from the human's heatmap-scale extent; per
    joint an int-truncated gaussian max-composite. Returns (H_hm, W_hm, J)
    clipped to [0, 1] — transpose-free channels-last."""
    w, h = HEATMAP_SIZE
    fs = np.array([IMAGE_SIZE[0] / w, IMAGE_SIZE[1] / h])
    J = joints_2d.shape[1]
    target = np.zeros((J, h, w), np.float32)
    for n in range(len(joints_2d)):
        vis = joints_vis[n] if joints_vis is not None else np.ones(J)
        human_scale = 2 * _compute_human_scale(joints_2d[n] / fs, vis)
        if human_scale == 0:
            continue
        cur_sigma = sigma * np.sqrt(human_scale / (96.0 * 96.0))
        for j in range(J):
            if joints_vis is not None and vis[j] == 0:
                continue
            peak = 1.0 if confidence is None else float(confidence[n, j])
            _stamp(target[j], int(joints_2d[n, j, 0] / fs[0]), int(joints_2d[n, j, 1] / fs[1]),
                   cur_sigma, peak, w, h)
    return np.clip(target, 0, 1).transpose(1, 2, 0)


def generate_3d_target(
    roots: np.ndarray,  # (P, 3) root positions, world scale
    space_size=(8000.0, 8000.0, 8000.0),
    space_center=(296.1, 826.0, -190.4),
    cube_size=(80, 80, 80),
    sigma: float = 200.0,
) -> np.ndarray:
    """generate_3d_target (:270-305): root gaussians on the coarse grid."""
    axes = [
        np.linspace(-space_size[i] / 2, space_size[i] / 2, cube_size[i]) + space_center[i]
        for i in range(3)
    ]
    target = np.zeros(cube_size, np.float32)
    for mu in roots:
        idx = []
        for i in range(3):
            lo = np.searchsorted(axes[i], mu[i] - 3 * sigma)
            hi = np.searchsorted(axes[i], mu[i] + 3 * sigma, "right")
            idx.append((lo, hi))
        if any(lo >= hi for lo, hi in idx):
            continue
        gx, gy, gz = np.meshgrid(*[axes[i][idx[i][0] : idx[i][1]] for i in range(3)], indexing="ij")
        g = np.exp(-((gx - mu[0]) ** 2 + (gy - mu[1]) ** 2 + (gz - mu[2]) ** 2) / (2 * sigma**2))
        sl = tuple(slice(lo, hi) for lo, hi in idx)
        target[sl] = np.maximum(target[sl], g)
    return np.clip(target, 0, 1)


def load_annotation_bodies(path: Path) -> tuple[list[np.ndarray], list[bool], list[str]]:
    """One pose-tool annotation json -> OR_4D-frame (14, 3) poses + patient
    flags (OR_4D.py:181-205; names sorted for determinism where the
    reference iterates a set)."""
    labels = json.load(open(path))["labels"]
    names = sorted({e["humanName"] for e in labels})
    bodies, is_patient = [], []
    for name in names:
        joints = {e["jointName"]: e["point3d"]["location"] for e in labels if e["humanName"] == name}
        pose = np.array([[joints[bp]["x"], joints[bp]["y"], joints[bp]["z"]] for bp in IDX_TO_BODY_PART])
        bodies.append(coord_transform_pose_tool_to_or4d(pose))
        is_patient.append(name == "Patient")
    return bodies, is_patient, names


def project_to_camera(points: np.ndarray, cam: dict, view: int) -> np.ndarray:
    """(N, 3) OR_4D world -> (N, 2) pixels, project_points_radial_OR_4D
    semantics via the folded cam dict (R = flip @ ext.R^T, T = 500 * ext.t)."""
    R, T = cam["R"][view], cam["T"][view]
    f, c = cam["f"][view], cam["c"][view]
    pc = (points - T) @ R.T / WORLD_SCALE
    z = pc[:, 2] + 1e-5
    return pc[:, :2] / z[:, None] * f + c


class VoxelPoseDataset:
    """Frame-level multi-view samples for VoxelPose training on 4D-OR."""

    def __init__(
        self,
        root: str | Path,
        split: str,
        pred_pose2d_path: str | Path | None = None,
        max_people: int = MAX_PEOPLE,
        inference: bool = False,
        take_indices: list[int] | None = None,
    ):
        self.root = Path(root)
        self.max_people = max_people
        self.inference = inference
        takes = take_indices if take_indices is not None else TAKE_SPLIT[split]
        takes = [t for t in takes if (self.root / f"export_holistic_take{t}_processed").exists()]
        if not takes:
            raise RuntimeError(f"no takes for split {split} under {self.root}")
        # camera rig from the FIRST take (OR_4D.py:169 — same rig every take)
        self.cam_infos = load_cam_infos(self.root / f"export_holistic_take{takes[0]}_processed")
        self.cameras = cam_infos_to_voxelpose(self.cam_infos)
        self.num_views = len(self.cam_infos)
        self.heatmap_scale = np.array(
            [HEATMAP_SIZE[0] / IMAGE_SIZE[0], HEATMAP_SIZE[1] / IMAGE_SIZE[1]], np.float32
        )
        self.pred_pose2d = None
        if pred_pose2d_path and Path(pred_pose2d_path).exists():
            self.pred_pose2d = np.load(pred_pose2d_path, allow_pickle=True)["arr_0"].item()
        self.db = self._build_db(takes)
        if not self.db:
            raise RuntimeError(f"no annotated frames for split {split} under {self.root}")

    def _build_db(self, takes) -> list[dict]:
        db = []
        for take_idx in takes:
            take_root = self.root / f"export_holistic_take{take_idx}_processed"
            frames = json.load(open(take_root / "timestamp_to_pcd_and_frames_list.json"))
            for _, channels in frames:
                pcd_idx = channels["pcd"]
                ann_path = take_root / "annotations" / f"{pcd_idx}.json"
                if not ann_path.exists():
                    if self.inference:
                        db.append({"take_idx": take_idx, "pcd_idx": pcd_idx, "channels": channels,
                                   "bodies": [], "is_patient": []})
                    continue
                bodies, is_patient, names = load_annotation_bodies(ann_path)
                if not bodies and not self.inference:
                    continue
                db.append({"take_idx": take_idx, "pcd_idx": pcd_idx, "channels": channels,
                           "bodies": bodies, "is_patient": is_patient, "names": names})
        return db

    def __len__(self) -> int:
        return len(self.db)

    def sample(self, index: int) -> dict:
        """One frame -> all-view arrays (channels-last heatmaps transposed
        to the model's (C, J, H, W) at the end):
          input_heatmaps  (C, J, H_hm, W_hm)
          target_heatmaps (C, J, H_hm, W_hm); target_weight (C, J)
          target_3d       (80, 80, 80)
          gt_poses (P, J, 3)  gt_vis (P, J)  gt_roots (P, 3)
          gt_mask (P,)  patient_mask (P,)
        """
        rec = self.db[index]
        P, J = self.max_people, NUM_JOINTS
        gt_poses = np.zeros((P, J, 3), np.float32)
        gt_vis = np.zeros((P, J), np.float32)
        gt_mask = np.zeros(P, bool)
        patient_mask = np.zeros(P, bool)
        bodies = rec["bodies"][:P]
        for i, b in enumerate(bodies):
            gt_poses[i] = b
            gt_vis[i] = 1.0
            gt_mask[i] = True
            patient_mask[i] = rec["is_patient"][i]
        roots = (gt_poses[:, ROOT_IDS[0]] + gt_poses[:, ROOT_IDS[1]]) / 2.0

        input_hms, target_hms, target_w = [], [], []
        for v in range(self.num_views):
            joints_2d = np.zeros((len(bodies), J, 2), np.float32)
            vis2d = np.zeros((len(bodies), J), np.float32)
            for i, b in enumerate(bodies):
                xy = project_to_camera(b, self.cameras, v)
                joints_2d[i] = xy
                inb = (
                    (xy[:, 0] >= 0) & (xy[:, 0] <= IMAGE_SIZE[0] - 1)
                    & (xy[:, 1] >= 0) & (xy[:, 1] <= IMAGE_SIZE[1] - 1)
                )
                vis2d[i] = inb.astype(np.float32)
            tgt = generate_heatmap(joints_2d, vis2d)
            target_hms.append(tgt.transpose(2, 0, 1))
            target_w.append((vis2d.max(axis=0) if len(bodies) else np.zeros(J)).astype(np.float32))

            pred = self._pred_for(rec, v)
            if pred is not None:
                inp = generate_heatmap(pred[..., :2], None, confidence=pred[..., 2])
            elif len(bodies):
                # no 2D-backbone predictions on disk: GT-rendered input
                # heatmaps (the reference's USE_GT-style fallback)
                inp = generate_heatmap(joints_2d, vis2d)
            else:
                inp = np.zeros((HEATMAP_SIZE[1], HEATMAP_SIZE[0], J), np.float32)
            input_hms.append(inp.transpose(2, 0, 1))

        return {
            "input_heatmaps": np.stack(input_hms),
            "target_heatmaps": np.stack(target_hms),
            "target_weight": np.stack(target_w),
            "target_3d": generate_3d_target(roots[gt_mask]),
            "gt_poses": gt_poses,
            "gt_vis": gt_vis,
            "gt_roots": roots,
            "gt_mask": gt_mask,
            "patient_mask": patient_mask,
            "meta": {"take_idx": rec["take_idx"], "pcd_idx": rec["pcd_idx"],
                     "names": rec.get("names", [])},
        }

    def _pred_for(self, rec, view: int) -> np.ndarray | None:
        """pred_or_4d_hrnet_coco_{split}.npz lookup by the reference's
        '{take}_camera0{k}_colorimage-{rgb}.jpg' identifier."""
        if self.pred_pose2d is None:
            return None
        rgb_str = rec["channels"][f"color_{view + 1}"]
        key = f"{rec['take_idx']}_camera0{view + 1}_colorimage-{rgb_str}.jpg"
        preds = self.pred_pose2d.get(key)
        if preds is None or not len(preds):
            return None
        return np.stack([np.asarray(p, np.float32) for p in preds])
