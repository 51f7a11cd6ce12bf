"""Associative-embedding grouping for HigherHRNet — the reference
HeatmapParser, faithfully (port of ``or4d_tpu/pipeline/ae_grouping.py``;
numpy and scipy, as there).

Reference: `external_src/HigherHRNet/higherhrnet_lib/core/group.py`:
  * nms (:140-144): kxk max-pool equality keep (config TEST.NMS_KERNEL 5);
  * top_k (:150-180): per-joint top max_num_people peaks with their tags;
  * match_by_tag (:25-96): joints are introduced in joint_order (identity
    for OR_4D); each new joint row is assigned to an existing person by
    MUNKRES (Hungarian) assignment on the cost
    round(|tag - person_mean_tag|) * 100 - detection_score
    (USE_DETECTION_VAL), accepting only pairs whose RAW tag distance is
    under TAG_THRESHOLD (1.0), otherwise seeding a new person;
  * adjust (:183-200): quarter-pixel offset toward the larger neighbor
    (+ the reference's 0.5 center shift and x/y swap quirks, kept);
  * refine (:203-266): for each person, re-scan det - round(|tag - mean|)
    for missing joints and fill them in;
  * parse (:268-288): match -> adjust -> scores (mean joint score) ->
    refine.

Hungarian assignment uses scipy.optimize.linear_sum_assignment — the same
optimum the munkres package computes, including the reference's 1e10
column padding when there are more fresh joints than persons.
"""

from __future__ import annotations

import numpy as np

DETECTION_THRESHOLD = 0.1  # config.yaml TEST.DETECTION_THRESHOLD
TAG_THRESHOLD = 1.0
MAX_NUM_PEOPLE = 10
NMS_KERNEL = 5


def nms_heatmaps(det: np.ndarray, kernel: int = NMS_KERNEL) -> np.ndarray:
    """(J, H, W) -> peaks-only: zero every pixel that is not the max of its
    kernel-neighborhood (HeatmapParser.nms)."""
    from scipy.ndimage import maximum_filter

    maxm = maximum_filter(det, size=(1, kernel, kernel), mode="constant")
    return np.where(det == maxm, det, 0.0)


def top_k(det: np.ndarray, tag: np.ndarray, max_people: int = MAX_NUM_PEOPLE):
    """Per-joint top-k peaks (HeatmapParser.top_k): returns
    (tag_k (J,K,1), loc_k (J,K,2) xy, val_k (J,K))."""
    J, H, W = det.shape
    det = nms_heatmaps(det)
    flat = det.reshape(J, -1)
    ind = np.argsort(-flat, axis=1)[:, :max_people]
    val_k = np.take_along_axis(flat, ind, axis=1)
    tag_flat = tag.reshape(J, H * W, -1)
    tag_k = np.take_along_axis(tag_flat, ind[..., None], axis=1)
    x = ind % W
    y = ind // W
    loc_k = np.stack([x, y], axis=2)
    return tag_k, loc_k, val_k


def match_by_tag(
    tag_k: np.ndarray,
    loc_k: np.ndarray,
    val_k: np.ndarray,
    num_joints: int,
    max_people: int = MAX_NUM_PEOPLE,
    detection_threshold: float = DETECTION_THRESHOLD,
    tag_threshold: float = TAG_THRESHOLD,
    use_detection_val: bool = True,
    ignore_too_much: bool = False,
    joint_order: list[int] | None = None,
) -> np.ndarray:
    """group.py:25-96 — returns (P, J, 3 + tag_dim) people arrays."""
    from scipy.optimize import linear_sum_assignment

    tag_dim = tag_k.shape[2]
    default = np.zeros((num_joints, 3 + tag_dim))
    order = joint_order if joint_order is not None else list(range(num_joints))

    joint_dict: dict = {}
    tag_dict: dict = {}
    for i in range(num_joints):
        idx = order[i]
        tags = tag_k[idx]
        joints = np.concatenate([loc_k[idx], val_k[idx, :, None], tags], axis=1)
        mask = joints[:, 2] > detection_threshold
        tags = tags[mask]
        joints = joints[mask]
        if joints.shape[0] == 0:
            continue

        if i == 0 or len(joint_dict) == 0:
            for tag, joint in zip(tags, joints):
                key = tag[0]
                joint_dict.setdefault(key, np.copy(default))[idx] = joint
                tag_dict[key] = [tag]
            continue

        grouped_keys = list(joint_dict.keys())[:max_people]
        grouped_tags = [np.mean(tag_dict[k], axis=0) for k in grouped_keys]
        if ignore_too_much and len(grouped_keys) == max_people:
            continue

        diff = joints[:, None, 3:] - np.array(grouped_tags)[None, :, :]
        diff_normed = np.linalg.norm(diff, ord=2, axis=2)
        diff_saved = np.copy(diff_normed)
        if use_detection_val:
            diff_normed = np.round(diff_normed) * 100 - joints[:, 2:3]

        num_added, num_grouped = diff_normed.shape
        if num_added > num_grouped:
            diff_normed = np.concatenate(
                [diff_normed, np.zeros((num_added, num_added - num_grouped)) + 1e10], axis=1
            )
        rows, cols = linear_sum_assignment(diff_normed)
        for row, col in zip(rows, cols):
            if row < num_added and col < num_grouped and diff_saved[row][col] < tag_threshold:
                key = grouped_keys[col]
                joint_dict[key][idx] = joints[row]
                tag_dict[key].append(tags[row])
            else:
                key = tags[row][0]
                joint_dict.setdefault(key, np.copy(default))[idx] = joints[row]
                tag_dict[key] = [tags[row]]

    if not joint_dict:
        return np.zeros((0, num_joints, 3 + tag_dim), np.float32)
    return np.array([joint_dict[k] for k in joint_dict]).astype(np.float32)


def adjust(people: np.ndarray, det: np.ndarray) -> np.ndarray:
    """Quarter-pixel refinement (group.py:183-200). The reference reads the
    heatmap transposed (tmp[xx, yy]) and emits (y + 0.5, x + 0.5) into the
    xy slots — a double swap that nets out to plain xy + 0.5 with the
    gradient probed on the transposed map; kept bit-for-bit."""
    for person in people:
        for joint_id, joint in enumerate(person):
            if joint[2] > 0:
                y, x = joint[0:2]
                xx, yy = int(x), int(y)
                tmp = det[joint_id]
                if tmp[xx, min(yy + 1, tmp.shape[1] - 1)] > tmp[xx, max(yy - 1, 0)]:
                    y += 0.25
                else:
                    y -= 0.25
                if tmp[min(xx + 1, tmp.shape[0] - 1), yy] > tmp[max(0, xx - 1), yy]:
                    x += 0.25
                else:
                    x -= 0.25
                person[joint_id, 0:2] = (y + 0.5, x + 0.5)
    return people


def refine(det: np.ndarray, tag: np.ndarray, keypoints: np.ndarray) -> np.ndarray:
    """Fill in missing joints by re-scanning det - round(|tag - mean tag|)
    (group.py:203-266)."""
    if tag.ndim == 3:
        tag = tag[..., None]
    tags = []
    for i in range(keypoints.shape[0]):
        if keypoints[i, 2] > 0:
            x, y = keypoints[i][:2].astype(np.int32)
            tags.append(tag[i, y, x])
    if not tags:
        return keypoints
    prev_tag = np.mean(tags, axis=0)
    ans = []
    for i in range(keypoints.shape[0]):
        tmp = det[i, :, :]
        tt = ((tag[i, :, :] - prev_tag[None, None, :]) ** 2).sum(axis=2) ** 0.5
        tmp2 = tmp - np.round(tt)
        y, x = np.unravel_index(np.argmax(tmp2), tmp.shape)
        xx, yy = x, y
        val = tmp[y, x]
        x += 0.5
        y += 0.5
        if tmp[yy, min(xx + 1, tmp.shape[1] - 1)] > tmp[yy, max(xx - 1, 0)]:
            x += 0.25
        else:
            x -= 0.25
        if tmp[min(yy + 1, tmp.shape[0] - 1), xx] > tmp[max(0, yy - 1), xx]:
            y += 0.25
        else:
            y -= 0.25
        ans.append((x, y, val))
    ans = np.array(ans)
    for i in range(det.shape[0]):
        if ans[i, 2] > 0 and keypoints[i, 2] == 0:
            keypoints[i, :2] = ans[i, :2]
            keypoints[i, 2] = ans[i, 2]
    return keypoints


def parse_heatmaps(
    det: np.ndarray,  # (J, H, W) aggregated heatmaps
    tag: np.ndarray,  # (J, H, W) or (J, H, W, tag_dim) embedding tags
    max_people: int = MAX_NUM_PEOPLE,
    do_adjust: bool = True,
    do_refine: bool = True,
    detection_threshold: float = DETECTION_THRESHOLD,
    tag_threshold: float = TAG_THRESHOLD,
) -> tuple[np.ndarray, list[float]]:
    """HeatmapParser.parse (:268-288): (people (P, J, 3+tag), scores)."""
    J = det.shape[0]
    tag4 = tag if tag.ndim == 4 else tag[..., None]
    people = match_by_tag(
        *top_k(det, tag4, max_people),
        num_joints=J,
        max_people=max_people,
        detection_threshold=detection_threshold,
        tag_threshold=tag_threshold,
    )
    if do_adjust and len(people):
        people = adjust(people, det)
    scores = [float(p[:, 2].mean()) for p in people]
    if do_refine:
        for i in range(len(people)):
            people[i] = refine(det, tag4, people[i])
    return people, scores
