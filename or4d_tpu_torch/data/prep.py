"""Scene -> fixed-shape tensor preparation (port of ``or4d_tpu/data/prep.py``).

Reference: `scene_graph_helpers/dataset/data_preparation_utils.py:52-240`:
  * object slots follow sorted instance-id order (instance2mask counter over
    `np.unique(instances)`, :77-104 — note the reference's shuffle_objs only
    shuffles a dead list, so sorted order is the effective semantics);
  * per-object crop: bbox +- 0.2 padding recorded, voxel-downsample sweep to
    num_points (:110-125), zero-mean + unit-sphere normalize (:12-18);
  * fully connected directed edges over valid objects (:127-137);
  * GT adjacency from the relationship json, default 'none' (:139-171);
  * per-edge union-bbox crop of the full cloud with a mask channel
    (1=subject points, 2=object points), num_points_union, zero-mean; hand
    locations carried into the crop frame (:173-224);
  * subject/object coarse-type one-hots (:195-197).

Deviation (documented): the reference downsample uses open3d
`voxel_down_sample_and_trace` keeping up to 8 arbitrary points per voxel;
here the voxel grid keeps the up-to-8 LOWEST-index points per voxel — a
deterministic re-spec with the same density-equalizing distribution. The
random final subset uses an explicit numpy Generator so cached samples are
reproducible.

The port keeps the reference package's numpy branches (voxel sweep and
union crop); the native ingest library is not used.
"""

from __future__ import annotations

import numpy as np

from or4d_tpu_torch.config import DatasetConfig
from or4d_tpu_torch.data.scene_batch import SceneSample
from or4d_tpu_torch.data.vocab import Vocab, objname_to_type_index

_VOXEL_SWEEP = range(15, 100, 5)  # reference: data_preparation_utils.py:44
_MAX_PER_VOXEL = 8


def zero_mean(points: np.ndarray) -> tuple[np.ndarray, dict]:
    """Zero-mean + unit-max-norm normalization (data_preparation_utils.py:12-18)."""
    mean = points.mean(axis=0, keepdims=True)
    out = points - mean
    dist = np.sqrt((out**2).sum(axis=1)).max()
    dist = dist if dist > 0 else 1.0
    out = out / dist
    return out, {"mean": mean, "dist": dist}


def voxel_downsample_indices(xyz: np.ndarray, voxel_size: float) -> np.ndarray:
    """Indices of the up-to-8 lowest-index points in each occupied voxel."""
    mn = xyz.min(axis=0)
    vox = np.floor((xyz - mn) / voxel_size).astype(np.int64)
    # collision-free voxel key via mixed radix
    dims = vox.max(axis=0) + 1
    key = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
    order = np.argsort(key, kind="stable")
    sk = key[order]
    # rank within each voxel group
    first = np.ones(len(sk), dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    group_start = np.maximum.accumulate(np.where(first, np.arange(len(sk)), 0))
    rank = np.arange(len(sk)) - group_start
    keep = order[rank < _MAX_PER_VOXEL]
    return np.sort(keep)


def calculate_downsample_indices(points: np.ndarray, target_n: int, rng: np.random.Generator) -> np.ndarray:
    """The reference's sweep (data_preparation_utils.py:37-49): coarsen the
    voxel size until <= target remains, keep the last choice above target,
    then draw the final subset."""
    n = len(points)
    if n < target_n:
        return rng.choice(n, target_n, replace=True)
    best = np.arange(n)
    for size in _VOXEL_SWEEP:
        choice = voxel_downsample_indices(points[:, :3], float(size))
        if len(choice) > target_n:
            best = choice
        else:
            break
    return best[rng.choice(len(best), target_n, replace=False)]


def prepare_scene(
    points: np.ndarray,
    instances: np.ndarray,
    objs: dict[int, str],
    rel_list: list,
    vocab: Vocab,
    ds: DatasetConfig,
    rng: np.random.Generator,
    hand_locations: dict[int, np.ndarray] | None = None,
    scan_id: str = "",
    take_idx: int = 0,
    bbox_padding: float = 0.2,
    pair_shared: bool = False,
    multi_rel: bool = False,
) -> SceneSample:
    """Build a padded SceneSample from a labeled scene cloud.

    ``points``: (N, 6) xyz+rgb; ``instances``: (N,) int labels matching the
    keys of ``objs`` (0/-1 = background); ``objs``: instance id -> class name;
    ``rel_list``: [[sub_id, obj_id, rel_idx, rel_name], ...].

    ``pair_shared``: sample each union crop ONCE per unordered pair and store
    it on both directed edges with the mask channel swapped (1<->2). The
    reference's crop construction (data_preparation_utils.py:199-217) filters
    the same scene array with the same union bbox for both directions — the
    xyz/rgb content, scan order, and zero-mean frame are direction-invariant
    by construction, and only the final random subsample draw differs. Tying
    that draw is a legal resampling (identical per-edge distribution) that
    lets the eval path share FPS/ball-query/selection work across the two
    directions of a pair (models/pointnet2.py paired path).

    ``multi_rel``: MULTI_REL_OUTPUTS mode — gt_rels becomes an (E, R) float32
    multi-hot (reference data_preparation_utils.py:141-190: all-zero default,
    every relation of an edge set to 1, accumulating instead of the
    single-label branch's last-write-wins) for the sigmoid relation head and
    its BCE loss.
    """
    O, E = ds.max_objects, ds.max_edges
    Po, Pr = ds.num_points_objects, ds.num_points_relation

    slot_ids = sorted(k for k in objs if k > 0)  # sorted instance-id order
    names = [objs[k] for k in slot_ids]
    n = len(slot_ids)
    if n > O:
        raise ValueError(f"scene has {n} objects > max_objects {O}")

    obj_points = np.zeros((O, Po, 6), np.float32)
    gt_class = np.zeros((O,), np.int32)
    obj_mask = np.zeros((O,), bool)
    bboxes = []
    point_masks = []  # per slot: boolean point membership
    for s, (inst_id, name) in enumerate(zip(slot_ids, names)):
        sel = instances == inst_id
        pts = points[sel]
        if len(pts) == 0:
            raise ValueError(f"instance {inst_id} ({name}) has no points")
        bboxes.append((pts[:, :3].min(0) - bbox_padding, pts[:, :3].max(0) + bbox_padding))
        point_masks.append(sel)
        choice = calculate_downsample_indices(pts, Po, rng)
        crop = pts[choice].astype(np.float32)
        crop[:, :3], _ = zero_mean(crop[:, :3])
        obj_points[s] = crop
        gt_class[s] = vocab.class_index(name)
        obj_mask[s] = True

    # GT adjacency, default 'none' (data_preparation_utils.py:139-160);
    # multi_rel: (n, n, R) multi-hot with all-zero default (:141-158)
    id_to_slot = {inst: s for s, inst in enumerate(slot_ids)}
    R = vocab.num_relations
    adj_multi = np.zeros((n, n, R), np.float32)
    adj = np.full((n, n), vocab.none_index, np.int32)
    for r in rel_list:
        if r[0] not in id_to_slot or r[1] not in id_to_slot:
            continue
        if r[3] not in vocab.relation_names:
            continue
        adj[id_to_slot[r[0]], id_to_slot[r[1]]] = vocab.relation_index(r[3])
        adj_multi[id_to_slot[r[0]], id_to_slot[r[1]], vocab.relation_index(r[3])] = 1.0

    edge_index = np.zeros((E, 2), np.int32)
    if multi_rel:
        gt_rels = np.zeros((E, R), np.float32)
    else:
        gt_rels = np.full((E,), vocab.none_index, np.int32)
    rel_onehot = np.zeros((E, 12), np.float32)
    rel_points = np.zeros((E, Pr, 7), np.float32)
    rel_hand_points = np.zeros((E, 2, 3), np.float32)
    edge_mask = np.zeros((E,), bool)

    def build_crop(a: int, b: int):
        """Sampled, zero-meaned union crop for directed edge (a, b)."""
        mn = np.minimum(bboxes[a][0], bboxes[b][0])
        mx = np.maximum(bboxes[a][1], bboxes[b][1])
        inside = np.all((points[:, :3] > mn) & (points[:, :3] < mx), axis=1)
        mask_channel = point_masks[a].astype(np.float32) * 1.0 + point_masks[b].astype(np.float32) * 2.0
        pts7 = np.concatenate([points, mask_channel[:, None]], axis=1)[inside]
        choice = calculate_downsample_indices(pts7, Pr, rng)
        crop = pts7[choice].astype(np.float32)
        crop[:, :3], info = zero_mean(crop[:, :3])
        return crop, info

    pair_crops: dict[tuple[int, int], tuple[np.ndarray, dict]] = {}
    e = 0
    for a in range(n):
        for b in range(n):
            if a == b:
                continue
            if e >= E:
                raise ValueError(f"scene has more than max_edges={E} edges")
            edge_index[e] = (a, b)
            gt_rels[e] = adj_multi[a, b] if multi_rel else adj[a, b]
            rel_onehot[e, objname_to_type_index(names[a])] = 1.0
            rel_onehot[e, 6 + objname_to_type_index(names[b])] = 1.0

            if pair_shared and (b, a) in pair_crops:
                fwd, info = pair_crops.pop((b, a))
                crop = fwd.copy()
                m = crop[:, 6]
                crop[:, 6] = np.where(m > 0, 3.0 - m, 0.0)  # swap 1 <-> 2
            else:
                crop, info = build_crop(a, b)
                if pair_shared:
                    pair_crops[(a, b)] = (crop, info)
            rel_points[e] = crop
            if hand_locations and slot_ids[a] in hand_locations:
                hp = np.asarray(hand_locations[slot_ids[a]], np.float32).reshape(2, 3)
                rel_hand_points[e] = (hp - info["mean"]) / info["dist"]
            edge_mask[e] = True
            e += 1

    return SceneSample(
        obj_points=obj_points,
        rel_points=rel_points,
        edge_index=edge_index,
        rel_onehot=rel_onehot,
        gt_class=gt_class,
        gt_rels=gt_rels,
        obj_mask=obj_mask,
        edge_mask=edge_mask,
        rel_hand_points=rel_hand_points,
        scan_id=scan_id,
        take_idx=take_idx,
        slot_names=tuple(names),
    )
