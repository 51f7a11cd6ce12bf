"""Relation macro F1, the metric of record: argmax predictions over the
valid edges against the ground truth, per-class precision, recall and F1
with zero division read as 0, averaged over the classes. Copied from the
program's ``or4d_tpu_torch/train/metrics.py`` (``classification_report``,
``RelationMetricAccumulator``), which follows sklearn's report."""

from __future__ import annotations

import numpy as np


def macro_f1(preds, gts, n: int) -> float:
    y_true = np.asarray(gts, np.int64)
    y_pred = np.asarray(preds, np.int64)
    tp = np.bincount(y_true[(y_true == y_pred) & (y_true >= 0) & (y_true < n)], minlength=n)[:n].astype(np.float64)
    pred_count = np.bincount(y_pred[(y_pred >= 0) & (y_pred < n)], minlength=n)[:n].astype(np.float64)
    true_count = np.bincount(y_true[(y_true >= 0) & (y_true < n)], minlength=n)[:n].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(true_count > 0, tp / true_count, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return float(f1.mean())


def batches_f1(logprobs: list, gt_rels: list, edge_masks: list, n: int) -> float:
    """Macro F1 over batches of relation log-probs (S, E, R) on the host."""
    preds, gts = [], []
    for lp, gt, m in zip(logprobs, gt_rels, edge_masks):
        m = np.asarray(m, bool)
        preds.append(np.asarray(lp).argmax(-1)[m])
        gts.append(np.asarray(gt)[m])
    return macro_f1(np.concatenate(preds), np.concatenate(gts), n)
