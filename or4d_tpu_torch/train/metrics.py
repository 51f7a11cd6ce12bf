"""Evaluation metrics (a numpy copy of ``or4d_tpu/train/metrics.py``): the
reference's sklearn classification_report bookkeeping
(scene_graph_prediction_model.py:195-238).

Per-take accumulation of relation predictions/GT, per-take reports, and the
metric of record: relation macro F1 over all takes.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


@dataclasses.dataclass
class ClassReport:
    labels: list[str]
    precision: np.ndarray
    recall: np.ndarray
    f1: np.ndarray
    support: np.ndarray

    @property
    def macro_precision(self) -> float:
        return float(self.precision.mean())

    @property
    def macro_recall(self) -> float:
        return float(self.recall.mean())

    @property
    def macro_f1(self) -> float:
        return float(self.f1.mean())

    @property
    def weighted_f1(self) -> float:
        tot = self.support.sum()
        return float((self.f1 * self.support).sum() / tot) if tot else 0.0

    @property
    def weighted_precision(self) -> float:
        tot = self.support.sum()
        return float((self.precision * self.support).sum() / tot) if tot else 0.0

    @property
    def weighted_recall(self) -> float:
        tot = self.support.sum()
        return float((self.recall * self.support).sum() / tot) if tot else 0.0

    def to_text(self) -> str:
        w = max(len(l) for l in self.labels) + 2
        lines = [f"{'':<{w}} {'prec':>6} {'rec':>6} {'f1':>6} {'support':>8}"]
        for i, l in enumerate(self.labels):
            lines.append(f"{l:<{w}} {self.precision[i]:6.2f} {self.recall[i]:6.2f} {self.f1[i]:6.2f} {int(self.support[i]):8d}")
        lines.append(f"{'macro avg':<{w}} {self.macro_precision:6.2f} {self.macro_recall:6.2f} {self.macro_f1:6.2f} {int(self.support.sum()):8d}")
        lines.append(f"{'weighted avg':<{w}} {self.weighted_precision:6.2f} {self.weighted_recall:6.2f} {self.weighted_f1:6.2f} {int(self.support.sum()):8d}")
        return "\n".join(lines)


def classification_report(y_true, y_pred, labels: list[str]) -> ClassReport:
    """sklearn-compatible per-class precision/recall/F1 over label ids
    0..len(labels)-1 (zero_division=0 semantics)."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    n = len(labels)
    # out-of-range ids count toward the other side's totals but never match
    tp = np.bincount(y_true[(y_true == y_pred) & (y_true >= 0) & (y_true < n)], minlength=n)[:n].astype(np.float64)
    pred_count = np.bincount(y_pred[(y_pred >= 0) & (y_pred < n)], minlength=n)[:n].astype(np.float64)
    true_count = np.bincount(y_true[(y_true >= 0) & (y_true < n)], minlength=n)[:n].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(true_count > 0, tp / true_count, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return ClassReport(list(labels), precision, recall, f1, true_count)


class RelationMetricAccumulator:
    """Per-take relation prediction bookkeeping (reference update_metrics /
    evaluate_predictions)."""

    def __init__(self, relation_names: list[str]):
        self.relation_names = list(relation_names)
        self.reset()

    def reset(self):
        self.take_preds: dict[int, list[int]] = defaultdict(list)
        self.take_gts: dict[int, list[int]] = defaultdict(list)

    def update(self, take_idx: int, preds, gts, mask=None):
        preds = _np(preds).reshape(-1)
        gts = _np(gts).reshape(-1)
        if mask is not None:
            m = _np(mask).reshape(-1).astype(bool)
            preds, gts = preds[m], gts[m]
        self.take_preds[take_idx].extend(preds.tolist())
        self.take_gts[take_idx].extend(gts.tolist())

    def update_batch(self, batch, rel_logprobs):
        """Accumulate a whole SceneBatch given the relation head's log-probs
        (S, E, R): argmax predictions over the valid edges, per take.
        Multi-hot gt_rels (MULTI_REL_OUTPUTS; the head's output is then
        sigmoid probabilities) are reduced to single labels on both sides
        alike: argmax where any bit or probability clears 0.5, 'none'
        otherwise (or4d_tpu/train/metrics.py:102-121)."""
        out = _np(rel_logprobs)
        gt = _np(batch.gt_rels)
        if gt.ndim == 3:
            names = list(self.relation_names)
            none_idx = names.index("none") if "none" in names else len(names) - 1
            preds = np.where(out.max(-1) > 0.5, out.argmax(-1), none_idx)
            gt = np.where(gt.max(-1) > 0.5, gt.argmax(-1), none_idx)
        else:
            preds = out.argmax(-1)
        for s, take_idx in enumerate(batch.take_idxs):
            self.update(take_idx, preds[s], gt[s], _np(batch.edge_mask)[s])

    def per_take_reports(self) -> dict[int, ClassReport]:
        return {
            t: classification_report(self.take_gts[t], self.take_preds[t], self.relation_names)
            for t in sorted(self.take_preds)
        }

    def overall_report(self) -> ClassReport:
        gts = [g for t in sorted(self.take_gts) for g in self.take_gts[t]]
        preds = [p for t in sorted(self.take_preds) for p in self.take_preds[t]]
        return classification_report(gts, preds, self.relation_names)

    @property
    def macro_f1(self) -> float:
        return self.overall_report().macro_f1
