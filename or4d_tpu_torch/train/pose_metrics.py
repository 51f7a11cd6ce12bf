"""3D pose evaluation metrics — MPJPE and PCP (port of
``or4d_tpu/train/pose_metrics.py``; numpy).

Reference: `external_src/voxelpose/voxelpose_lib/dataset/OR_4D.py:343-380`
(per-person greedy matching by root distance, then per-joint error stats) and
the PCP ("percentage of correct parts") limb criterion over the 14-joint
skeleton.
"""

from __future__ import annotations

import numpy as np

from or4d_tpu_torch.config import LIMBS


def match_poses(pred: np.ndarray, gt: np.ndarray) -> list[tuple[int, int]]:
    """Greedy 1:1 matching by mean joint distance (closest pair first)."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    if len(pred) == 0 or len(gt) == 0:
        return []
    d = np.linalg.norm(pred[None, :, :, :] - gt[:, None, :, :], axis=-1).mean(-1)  # (G, P)
    pairs = []
    used_g, used_p = set(), set()
    for _ in range(min(len(pred), len(gt))):
        masked = d.copy()
        for g in used_g:
            masked[g, :] = np.inf
        for p in used_p:
            masked[:, p] = np.inf
        g, p = np.unravel_index(masked.argmin(), masked.shape)
        pairs.append((int(g), int(p)))
        used_g.add(g)
        used_p.add(p)
    return pairs


def mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean per-joint position error over greedily matched people (mm)."""
    pairs = match_poses(pred, gt)
    if not pairs:
        return float("nan")
    errs = [np.linalg.norm(np.asarray(pred)[p] - np.asarray(gt)[g], axis=-1).mean() for g, p in pairs]
    return float(np.mean(errs))


def pcp(pred: np.ndarray, gt: np.ndarray, threshold: float = 0.5) -> float:
    """Percentage of correct parts: a limb is correct when both endpoint
    errors are below threshold * limb length."""
    pairs = match_poses(pred, gt)
    if not pairs:
        return float("nan")
    correct = total = 0
    for g, p in pairs:
        gp, pp = np.asarray(gt)[g], np.asarray(pred)[p]
        for a, b in LIMBS:
            limb_len = np.linalg.norm(gp[a] - gp[b])
            if limb_len < 1e-6:
                continue
            ea = np.linalg.norm(pp[a] - gp[a])
            eb = np.linalg.norm(pp[b] - gp[b])
            correct += int(ea < threshold * limb_len and eb < threshold * limb_len)
            total += 1
    return float(correct / total) if total else float("nan")


def voxelpose_evaluate(
    preds: list[np.ndarray],
    gts: list[list[np.ndarray]],
    recall_threshold: float = 500.0,
    alpha: float = 0.5,
    max_actors: int = 10,
):
    """The reference OR_4D.evaluate, faithfully (OR_4D.py:340-380):

      * per GT person, the NEAREST prediction by MPJPE (no unique
        assignment); a GT counts as matched when min MPJPE < threshold;
      * PCP per limb uses the MEAN of the two endpoint errors vs
        alpha * limb length;
      * correct/total parts accumulate per PERSON SLOT INDEX across frames
        (actor_pcp), and avg_pcp averages the first THREE actor slots —
        reference quirks kept.

    ``preds[i]``: (P, J, 3) predicted poses for frame i (already filtered to
    valid proposals); ``gts[i]``: list of (J, 3) GT poses.
    Returns (actor_pcp (max_actors,), avg_pcp, None, recall).
    """
    total_gt = 0
    match_gt = 0
    correct_parts = np.zeros(max_actors)
    total_parts = np.zeros(max_actors)
    for pred, frame_gts in zip(preds, gts):
        pred = np.asarray(pred, np.float64).reshape(-1, 14, 3) if len(pred) else np.zeros((0, 14, 3))
        for person, gt in enumerate(frame_gts):
            gt = np.asarray(gt, np.float64)
            if gt.size == 0:
                continue
            if len(pred) == 0:
                total_gt += 1
                continue
            mpjpes = np.mean(np.sqrt(np.sum((gt[None] - pred) ** 2, axis=-1)), axis=-1)
            min_n = int(np.argmin(mpjpes))
            if float(np.min(mpjpes)) < recall_threshold:
                match_gt += 1
            total_gt += 1
            for a, b in LIMBS:
                total_parts[person] += 1
                error_s = np.linalg.norm(pred[min_n, a] - gt[a])
                error_e = np.linalg.norm(pred[min_n, b] - gt[b])
                limb_length = np.linalg.norm(gt[a] - gt[b])
                if (error_s + error_e) / 2.0 <= alpha * limb_length:
                    correct_parts[person] += 1
    actor_pcp = correct_parts / (total_parts + 1e-8)
    avg_pcp = float(np.mean(actor_pcp[:3]))
    return actor_pcp, avg_pcp, None, match_gt / (total_gt + 1e-8)


def recall_at(pred: np.ndarray, gt: np.ndarray, threshold_mm: float = 500.0) -> float:
    """Fraction of GT people whose matched prediction has root error below
    the threshold (the proposal-recall statistic)."""
    pairs = match_poses(pred, gt)
    if len(gt) == 0:
        return float("nan")
    hits = sum(
        1 for g, p in pairs if np.linalg.norm(np.asarray(pred)[p][0] - np.asarray(gt)[g][0]) < threshold_mm
    )
    return hits / len(gt)
