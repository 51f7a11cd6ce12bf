"""Group-Free 3D detection losses (port of ``or4d_tpu/models/groupfree_loss.py``).

Reference: `external_src/group_free_3D/models/{loss_helper,losses}.py`:
  * KPS hard-topk seed objectness (compute_points_obj_cls_loss_hard_topk
    :9-71): per GT box, the topk seeds closest (size-normalized) among seeds
    belonging to that instance are positives; sigmoid focal loss
    (gamma 2, alpha 0.25), per-batch-row weight normalization;
  * per-layer candidate objectness: a candidate is positive iff its seed
    point lies on an object (point_obj_mask gather chain :73-131);
  * per-layer box losses (compute_box_and_sem_cls_loss :132+): smooth-L1
    center to the assigned GT (assignment = the candidate seed's instance
    id), CE heading class + smooth-L1 normalized heading residual under the
    GT bin, CE size class + smooth-L1 normalized size residual, CE semantic
    class, all masked and normalized by the positive candidates;
  * total (get_loss :291+): query_points_generation_loss * 0.8 + the sum
    over heads (proposal + decoder layers) of objectness 0.1 + box + 0.1 sem.

Every seed that is not a member of a box's instance sits at distance exactly
100.0 from it, so a box with fewer than topk member seeds ties; the topk
selection is a stable sort, ties to the lowest seed index, as ``lax.top_k``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from or4d_tpu_torch.models.groupfree import NUM_HEADING_BIN, mean_sizes


def smoothl1(error: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    d = error.abs()
    return torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor, gamma: float = 2.0,
                       alpha: float = 0.25) -> torch.Tensor:
    """Per-element focal BCE (losses.py SigmoidFocalClassificationLoss)."""
    p = torch.sigmoid(logits)
    ce = torch.clamp_min(logits, 0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    alpha_w = alpha * targets + (1 - alpha) * (1 - targets)
    pt = targets * (1 - p) + (1 - targets) * p
    return alpha_w * pt ** gamma * ce * weights


def _take(arr: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """arr (B, K2) or (B, K2, C) gathered at assign (B, P) along K2."""
    if arr.dim() == 2:
        return torch.gather(arr, 1, assign)
    return torch.gather(arr, 1, assign[..., None].expand(-1, -1, arr.shape[-1]))


def kps_objectness_loss(seed_xyz, seed_logits, seed_instance, gt_center, gt_size, gt_mask, topk: int = 5):
    """compute_points_obj_cls_loss_hard_topk: seed_xyz (B, K, 3), seed_logits
    (B, K), seed_instance (B, K) instance id per seed (-1 background),
    gt_center / gt_size (B, K2, 3), gt_mask (B, K2)."""
    B, K, _ = seed_xyz.shape
    K2 = gt_center.shape[1]
    seed_instance = seed_instance.long()
    assign = torch.where(seed_instance < 0, K2 - 1, seed_instance)
    onehot = F.one_hot(assign, K2).float()  # (B, K, K2)
    delta = (seed_xyz[:, :, None, :] - gt_center[:, None, :, :]) / (gt_size[:, None, :, :] + 1e-6)
    dist = torch.sqrt((delta ** 2).sum(-1) + 1e-6)
    dist = dist * onehot + 100.0 * (1 - onehot)
    dist = dist.transpose(1, 2)  # (B, K2, K)
    top_idx = torch.sort(dist.detach(), dim=-1, stable=True).indices[..., :topk]  # closest seeds
    # positives: the union over valid GT boxes of their topk seeds
    updates = (gt_mask[:, :, None] != 0).float().expand(B, K2, topk)
    label = torch.zeros(B, K, device=seed_logits.device).scatter_reduce(
        1, top_idx.reshape(B, -1), updates.reshape(B, -1), "amax")
    label = torch.where(seed_instance < 0, 0.0, label)
    w = torch.ones(B, K, device=seed_logits.device) / K
    return sigmoid_focal_loss(seed_logits, label, w).sum() / B


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(torch.log_softmax(logits, dim=-1), -1, labels.long()[..., None])[..., 0]


def layer_losses(head_out: dict, cand_instance: torch.Tensor, gt: dict, mean_size_arr) -> dict:
    """compute_objectness_loss_based_on_query_points + the box and semantic
    losses of ONE prediction head. ``cand_instance`` (B, P): each
    candidate's seed instance (-1 background); ``gt``: center (B,K2,3),
    size_class (B,K2), size_residual (B,K2,3), heading_class (B,K2),
    heading_residual (B,K2), sem_class (B,K2), mask (B,K2)."""
    B, P = cand_instance.shape
    K2 = gt["center"].shape[1]
    cand_instance = cand_instance.long()
    pos = (cand_instance >= 0).float()  # objectness label
    assign = torch.where(cand_instance < 0, K2 - 1, cand_instance)

    w = torch.ones(B, P, device=pos.device) / P
    obj_loss = sigmoid_focal_loss(head_out["objectness"], pos, w).sum() / B
    denom = pos.sum() + 1e-6

    center_loss = (smoothl1(_take(gt["center"], assign) - head_out["center"]).sum(-1) * pos).sum() / denom

    per_bin = np.pi / NUM_HEADING_BIN
    hc = _take(gt["heading_class"].long(), assign)
    hc_loss = (_ce(head_out["heading_scores"], hc) * pos).sum() / denom
    hr_norm = _take(gt["heading_residual"], assign) / per_bin
    pred_hr_norm = torch.gather(head_out["heading_residual"] / per_bin, -1, hc[..., None])[..., 0]
    hr_loss = (smoothl1(pred_hr_norm - hr_norm) * pos).sum() / denom

    sc = _take(gt["size_class"].long(), assign)
    sc_loss = (_ce(head_out["size_scores"], sc) * pos).sum() / denom
    msz = mean_sizes(mean_size_arr, pos.device)[sc]  # (B, P, 3)
    gt_sr_norm = _take(gt["size_residual"], assign) / msz
    pred_sr = torch.gather(head_out["size_residual"], -2, sc[..., None, None].expand(-1, -1, 1, 3))[..., 0, :] / msz
    sr_loss = (smoothl1(pred_sr - gt_sr_norm).sum(-1) * pos).sum() / denom

    sem_loss = (_ce(head_out["sem_scores"], _take(gt["sem_class"].long(), assign)) * pos).sum() / denom

    box_loss = center_loss + 0.1 * hc_loss + hr_loss + 0.1 * sc_loss + sr_loss
    return {"objectness": obj_loss, "center": center_loss, "box": box_loss, "sem": sem_loss}


def groupfree_total_loss(outputs: dict, seed_instance: torch.Tensor, gt: dict, mean_size_arr, seed_xyz,
                         topk: int = 5, query_points_weight: float = 0.8, obj_weight: float = 0.1,
                         box_weight: float = 1.0, sem_weight: float = 0.1):
    """get_loss: the KPS seed loss + per head (proposal + decoder layers).
    Returns (total, parts)."""
    kps = kps_objectness_loss(seed_xyz, outputs["seeds_obj_cls_logits"], seed_instance, gt["center"], gt["size"],
                              gt["mask"], topk=topk)
    cand_instance = torch.gather(seed_instance.long(), 1, outputs["sample_inds"].long())
    total = query_points_weight * kps
    parts = {"kps": kps}
    heads = [("proposal", outputs["proposal"])] + [(f"head_{i}", h) for i, h in enumerate(outputs["layers"])]
    for name, head in heads:
        ls = layer_losses(head, cand_instance, gt, mean_size_arr)
        total = total + obj_weight * ls["objectness"] + box_weight * ls["box"] + sem_weight * ls["sem"]
        parts[name] = ls
    parts["total"] = total
    return total, parts
