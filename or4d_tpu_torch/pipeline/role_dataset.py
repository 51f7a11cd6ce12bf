"""Role-prediction dataset assembly: scene-graph tracks -> labeled
Graphormer batches (port of ``or4d_tpu/pipeline/role_dataset.py``).

Reference: `role_prediction/role_prediction_dataset.py`:
  * GT scene graphs in prediction format: Patient renamed to the next
    human_{i} slot, triplets as names (:19-52);
  * GT role labels per (take, frame, human) from human_idx_to_name +
    3D joints (:55-89);
  * track processing (:167-236): per human track, rename the tracked human
    to TARGET in every frame's graph, label the track by the nearest-GT-human
    majority role, star-expand + preprocess each frame, skip empty graphs,
    drop tracks labeled 'none'.

This module is host-side assembly on top of
:mod:`or4d_tpu_torch.pipeline.role_graphormer`; it also provides
synthetic-track generators (numpy ``default_rng``, the same arrays as the
JAX package's) so the Graphormer path trains and tests without the dataset
release.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path

import numpy as np

from or4d_tpu_torch.models.graphormer import GraphormerBatch
from or4d_tpu_torch.pipeline.role_graphormer import ROLE_TO_INDEX, track_to_batch

_SPLIT_FILES = {
    "train": "relationships_train.json",
    "val": "relationships_validation.json",
    "test": "relationships_test_dummy.json",
}


def load_gt_scene_graphs_in_prediction_format(data_root: str | Path = "data") -> dict[str, list]:
    """GT relationship jsons -> {scan_id: [(sub, rel, obj) names]} with
    Patient renamed to the next human slot (:19-52)."""
    out = {}
    for split, fname in _SPLIT_FILES.items():
        p = Path(data_root) / fname
        if not p.exists():
            continue
        for scan in json.loads(p.read_text())["scans"]:
            objects = dict(scan["objects"])
            if "Patient" in objects.values():
                humans = sorted(v for v in objects.values() if "human" in v)
                nxt = int(humans[-1].split("_")[-1]) + 1 if humans else 0
                for k, v in objects.items():
                    if v == "Patient":
                        objects[k] = f"human_{nxt}"
            rels = [
                (objects[str(s)], rel_name, objects[str(o)])
                for s, o, _ri, rel_name in scan["relationships"]
            ]
            out[f"{scan['take_idx']}_{scan['scan']}"] = rels
    return out


@dataclasses.dataclass
class RoleTrack:
    """One human track: frame -> (human_name, joints), plus its role label."""

    take_idx: int
    track_idx: int
    timestamp_to_human_pose: dict[str, tuple[str, np.ndarray]]
    role_label: int  # ROLE_TO_INDEX id

    def to_batch(self, frame_to_relations: dict[str, list], max_graphs: int | None = None) -> GraphormerBatch:
        frames = sorted(self.timestamp_to_human_pose)
        rels = [frame_to_relations.get(f, []) for f in frames]
        targets = [self.timestamp_to_human_pose[f][0] for f in frames]
        return track_to_batch(rels, targets, max_graphs=max_graphs)


def majority_role(labels: list[str | None]) -> str | None:
    """Track label = most common per-frame nearest-GT role (:228)."""
    labels = [l for l in labels if l is not None]
    if not labels:
        return None
    return Counter(labels).most_common(1)[0][0]


def label_track(track_poses: dict[str, tuple[str, np.ndarray]], frame_to_gt_humans: dict[str, dict]) -> str | None:
    """Per frame, the GT human nearest (L2 over joints) to the tracked human
    donates its role; the track takes the majority (:196-209, :228)."""
    labels = []
    for frame, (_name, joints) in sorted(track_poses.items()):
        gt = frame_to_gt_humans.get(frame)
        if not gt:
            labels.append(None)
            continue
        best, best_d = None, np.inf
        for _idx, (role, gt_joints) in gt.items():
            d = float(np.linalg.norm(np.asarray(joints) - np.asarray(gt_joints)))
            if d < best_d:
                best, best_d = role, d
        labels.append(best)
    return majority_role(labels)


def build_tracks(
    take_idx: int,
    raw_tracks: list[dict],
    frame_to_relations: dict[str, list],
    frame_to_gt_humans: dict[str, dict],
) -> list[RoleTrack]:
    """Reference process(): label + filter tracks ('none'/empty dropped)."""
    out = []
    for track_idx, track in enumerate(raw_tracks):
        poses = track["timestamp_to_human_pose"]
        role = label_track(poses, frame_to_gt_humans)
        if role in (None, "none"):
            continue
        # at least one non-empty graph required (:216)
        if not any(frame_to_relations.get(f) for f in poses):
            continue
        out.append(
            RoleTrack(
                take_idx=take_idx,
                track_idx=track_idx,
                timestamp_to_human_pose=poses,
                role_label=ROLE_TO_INDEX[role.replace("_", "-") if "-" not in role else role],
            )
        )
    return out


# ---------------------------------------------------------------------------
# synthetic fixtures (dataset-free training/CI)
# ---------------------------------------------------------------------------

_ROLE_BEHAVIORS = {
    "Patient": [("TARGET", "LyingOn", "operating_table")],
    "head-surgeon": [("TARGET", "Sawing", "human_9"), ("TARGET", "Holding", "instrument")],
    "assistant-surgeon": [("TARGET", "Assisting", "human_9"), ("TARGET", "CloseTo", "instrument_table")],
    "circulating-nurse": [("TARGET", "Touching", "secondary_table")],
    "anaesthetist": [("TARGET", "Operating", "anesthesia_equipment")],
}


def make_synthetic_track(role: str, n_frames: int = 4, seed: int = 0, human_name: str = "human_0"):
    """A track whose frames exhibit the role's characteristic relations.
    Returns (RoleTrack, frame_to_relations)."""
    rng = np.random.default_rng(seed)
    poses = {}
    frame_rels = {}
    for i in range(n_frames):
        frame = f"{i:06d}"
        poses[frame] = (human_name, rng.normal(size=(14, 3)))
        rels = [
            (human_name if s == "TARGET" else s, r, human_name if o == "TARGET" else o)
            for s, r, o in _ROLE_BEHAVIORS[role]
        ]
        rels.append(("human_8", "CloseTo", "operating_table"))
        frame_rels[frame] = rels
    track = RoleTrack(
        take_idx=1,
        track_idx=0,
        timestamp_to_human_pose=poses,
        role_label=ROLE_TO_INDEX[role if "-" in role or role == "Patient" else role],
    )
    return track, frame_rels


def make_synthetic_role_dataset(tracks_per_role: int = 2, n_frames: int = 4, max_graphs: int = 4):
    """[(GraphormerBatch, label)] over all 5 roles."""
    out = []
    for ri, role in enumerate(_ROLE_BEHAVIORS):
        for k in range(tracks_per_role):
            track, frame_rels = make_synthetic_track(role, n_frames=n_frames, seed=ri * 10 + k)
            out.append((track.to_batch(frame_rels, max_graphs=max_graphs), track.role_label))
    return out


def make_synthetic_role_take(take_idx: int = 1, n_frames: int = 4, max_graphs: int = 4):
    """One synthetic take: 5 co-occurring tracks (one per role, distinct
    human names) sharing the same frames, with a merged per-frame relation
    list — enough structure to run the full score -> per-frame-assignment ->
    role-json path without the dataset release.

    Returns (tracks, frame_to_relations, data) where ``tracks`` are RoleTracks
    whose track_idx matches their position and ``data`` is [(batch, label)].
    """
    rng = np.random.default_rng(take_idx)
    tracks: list[RoleTrack] = []
    frame_to_relations: dict[str, list] = {f"{i:06d}": [] for i in range(n_frames)}
    for ri, role in enumerate(_ROLE_BEHAVIORS):
        human = f"human_{ri}"
        poses = {}
        for i in range(n_frames):
            frame = f"{i:06d}"
            poses[frame] = (human, rng.normal(size=(14, 3)))
            frame_to_relations[frame].extend(
                (human if s == "TARGET" else s, r, human if o == "TARGET" else o)
                for s, r, o in _ROLE_BEHAVIORS[role]
            )
        tracks.append(RoleTrack(take_idx=take_idx, track_idx=ri,
                                timestamp_to_human_pose=poses, role_label=ri))
    data = [(t.to_batch(frame_to_relations, max_graphs=max_graphs), t.role_label) for t in tracks]
    return tracks, frame_to_relations, data
