"""Surgery-phase recognition — deterministic FSM over predicted scene graphs.

Reference: `surgery_phase_recognition/recognize_surgery_phase.py` (the 8-phase
knee-surgery state machine) and `evaluate_surgery_phase_recognition.py`.
Faithful rule-for-rule: role substitution into triplets, the triplet query
`q`, the temporal debounce `cond(window, threshold)`, the sawing-window
precondition, and the exact transition guards/windows/thresholds.

Outputs `{phase: (start_frame, end_frame)}` JSON matching
phases_to_frames/*_phase_to_frames_{take}.json (:182-189).

A numpy copy of ``or4d_tpu/pipeline/phases.py`` for the PyTorch port.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

PHASE_ORDER = [
    "sterile", "roll_in", "patient_prep", "knee_prep",
    "knee_insert", "surgery_conclusion", "roll_out", "cleanup",
]
PHASE_LONG_NAMES = [
    "OR Preparation", "Patient Roll-In", "Patient Preparation",
    "Surgery 1: Implant Placement Preparation", "Surgery 2: Implant Placement",
    "Surgery 3: Conclusion", "Patient Roll-Out", "OR Cleanup",
]


def augment_with_roles(rels: list, key: str, role_predictions: dict) -> list:
    """Substitute predicted roles for human names in triplets (:11-23)."""
    base_key = key.rsplit("_", 1)[0] if key.count("_") > 1 else key
    roles = role_predictions.get(base_key) or role_predictions.get(key)
    if not roles:
        return rels
    return [(roles.get(s, s), r, roles.get(o, o)) for s, r, o in rels]


def q(relationships: list, s: Optional[list] = None, r: Optional[list] = None, o: Optional[list] = None) -> bool:
    """Does any triplet match the (subjects, relations, objects) sets? (:26-42)"""
    for sub, rel, obj in relationships:
        if s is not None and sub not in s:
            continue
        if r is not None and rel not in r:
            continue
        if o is not None and obj not in o:
            continue
        return True
    return False


def cond(counter: list[int], window: int, threshold: int):
    """Temporal debounce: a window-length burst with >= threshold hits (:45-51)."""
    for center in counter:
        hits = [e for e in counter if abs(e - center) <= window // 2]
        if len(hits) >= threshold:
            return hits[0], True
    return None, False


def get_first_last_sawing(sgs: list[tuple[str, list]], role_predictions: dict):
    """First/last debounced head_surgeon-Sawing-Patient burst (:54-67)."""
    starts = []
    counter: list[int] = []
    for key, pred_sg in sgs:
        rels = augment_with_roles([tuple(r) for r in pred_sg], key, role_predictions)
        scan_idx = int(key.split("_")[1])
        if q(rels, s=["head_surgeon"], r=["Sawing"], o=["Patient"]):
            counter.append(scan_idx)
            start, flag = cond(counter, window=10, threshold=3)
            if flag:
                starts.append(start)
                counter = []
    if not starts:
        return None, None
    return starts[0], starts[-1] + 5


def recognize_phases(take_sgs: dict[str, list], role_predictions: dict) -> dict[str, tuple[int, int]]:
    """Run the FSM over one take's predicted scene graphs.

    ``take_sgs``: {"{take}_{scan}": [(sub, rel, obj), ...]} sorted by scan.
    Returns {phase: (start, end)}.
    """
    sgs = sorted(take_sgs.items())
    if not sgs:
        return {}
    phase_start = [("sterile", 0)]
    phase_end: list[tuple[str, int]] = []
    current = "sterile"
    mem: dict[str, list | bool] = {
        "patient_in": [], "patient_prep": [], "cleaning": [], "cleaning_done": False,
        "incision": [], "hammering": [], "cementing": [], "cementing_done": False,
        "suturing": [], "patient_out": [], "cleanup": [],
    }
    first_sawing, last_sawing = get_first_last_sawing(sgs, role_predictions)

    def transition(counter_key, window, threshold, next_phase, scan_idx):
        nonlocal current
        mem[counter_key].append(scan_idx)
        start, flag = cond(mem[counter_key], window=window, threshold=threshold)
        if flag:
            phase_end.append((current, start - 1))
            current = next_phase
            phase_start.append((current, start))
            return True
        return False

    for key, pred_sg in sgs:
        rels = augment_with_roles([tuple(r) for r in pred_sg], key, role_predictions)
        scan_idx = int(key.split("_")[1])

        if current == "sterile" and (q(rels, s=["Patient"]) or q(rels, o=["Patient"])) and q(rels, r=["Operating"], o=["operating_table"]):
            transition("patient_in", 5, 3, "roll_in", scan_idx)
        elif current == "roll_in" and q(rels, s=["head_surgeon"], r=["Preparing"]) and q(rels, s=["assistant_surgeon"], r=["Preparing"]):
            transition("patient_prep", 10, 3, "patient_prep", scan_idx)
        elif current == "patient_prep":
            if not mem["cleaning_done"]:
                if q(rels, s=["head_surgeon", "assistant_surgeon"], r=["Cleaning"], o=["Patient"]):
                    mem["cleaning"].append(scan_idx)
                    _, flag = cond(mem["cleaning"], window=10, threshold=3)
                    if flag:
                        mem["cleaning_done"] = True
            else:
                if q(rels, s=["head_surgeon", "assistant_surgeon"], r=["Cutting"]):
                    transition("incision", 10, 3, "knee_prep", scan_idx)
        elif current == "knee_prep":
            if last_sawing is not None and scan_idx > last_sawing and q(rels, s=["head_surgeon"], r=["Hammering"], o=["Patient"]):
                transition("hammering", 5, 3, "knee_insert", scan_idx)
        elif current == "knee_insert":
            if not mem["cementing_done"]:
                if q(rels, s=["head_surgeon", "assistant_surgeon"], r=["Cementing"], o=["Patient"]):
                    mem["cementing"].append(scan_idx)
                    _, flag = cond(mem["cementing"], window=10, threshold=3)
                    if flag:
                        mem["cementing_done"] = True
            else:
                if q(rels, s=["head_surgeon", "assistant_surgeon"], r=["Suturing"], o=["Patient"]):
                    transition("suturing", 10, 2, "surgery_conclusion", scan_idx)
        elif current == "surgery_conclusion" and (q(rels, s=["Patient"]) or q(rels, o=["Patient"])) and q(rels, r=["Operating"], o=["operating_table"]):
            transition("patient_out", 10, 8, "roll_out", scan_idx)
        elif current == "roll_out" and not q(rels, o=["Patient"]) and q(rels, s=["circulating_nurse", "anaesthetist"]):
            if transition("cleanup", 10, 3, "cleanup", scan_idx):
                phase_end.append((current, int(sgs[-1][0].split("_")[1])))

    phase_to_frames = {}
    for (ps, start), (pe, end) in zip(phase_start, phase_end):
        assert ps == pe
        phase_to_frames[ps] = (start, end)
    return phase_to_frames


def write_phase_json(path: str | Path, phase_to_frames: dict) -> None:
    Path(path).write_text(json.dumps(phase_to_frames))


def expand_to_per_frame(phase_to_frames: dict[str, tuple[int, int]], take_length: int | None = None) -> np.ndarray:
    """(start, end) ranges -> per-frame label array (evaluate_*.py:26-35);
    frames outside any phase get -1."""
    if take_length is None:
        take_length = int(max(end for _, end in phase_to_frames.values())) + 1
    labels = np.full(take_length, -1, np.int64)
    for phase, (start, end) in phase_to_frames.items():
        labels[start : end + 1] = PHASE_ORDER.index(phase)
    return labels


def evaluate_phases(gt: dict[str, tuple[int, int]], pred: dict[str, tuple[int, int]]):
    """Per-take classification report over per-frame phase labels."""
    from or4d_tpu_torch.train.metrics import classification_report as report

    take_length = int(max(end for _, end in gt.values())) + 1
    gts = expand_to_per_frame(gt, take_length)
    preds = expand_to_per_frame(pred, take_length)
    return report(gts, preds, PHASE_LONG_NAMES)


def evaluate_phase_dirs(gt_dir: str | Path, pred_dir: str | Path,
                        pred_stem: str | None = None) -> dict[str, object]:
    """The reference evaluator loop (evaluate_surgery_phase_recognition.py:11-49):
    per split, per take, load GT ``phase_to_frames_{take}.json`` and the
    prediction ``{stem}_phase_to_frames_{take}.json``, expand both to
    per-frame labels (GT take length), and build per-take + per-split
    classification reports. Returns {f"take_{t}" | split: ClassReport};
    takes with no GT or no prediction file are skipped."""
    from or4d_tpu_torch.config import TAKE_SPLIT
    from or4d_tpu_torch.train.metrics import classification_report as report

    gt_dir, pred_dir = Path(gt_dir), Path(pred_dir)
    reports: dict[str, object] = {}
    for split in ("train", "val", "test"):
        split_gts: list[np.ndarray] = []
        split_preds: list[np.ndarray] = []
        for take_idx in TAKE_SPLIT[split]:
            gt_path = gt_dir / f"phase_to_frames_{take_idx}.json"
            if not gt_path.exists():
                continue
            if pred_stem is not None:
                candidates = [pred_dir / f"{pred_stem}_phase_to_frames_{take_idx}.json"]
                candidates = [p for p in candidates if p.exists()]
            else:
                candidates = sorted(
                    p for p in pred_dir.glob(f"*phase_to_frames_{take_idx}.json")
                    if p.name != gt_path.name
                )
            if not candidates:
                continue
            if len(candidates) > 1:
                import warnings

                warnings.warn(
                    f"take {take_idx}: multiple prediction stems match "
                    f"({', '.join(p.name for p in candidates)}); using "
                    f"{candidates[0].name} — pass pred_stem to disambiguate",
                    stacklevel=2,
                )
            gt = json.loads(gt_path.read_text())
            pred = json.loads(candidates[0].read_text())
            if not gt:  # no phases annotated: nothing to score, skip the take
                continue
            take_length = int(max(end for _, end in gt.values())) + 1
            gts = expand_to_per_frame(gt, take_length)
            preds = expand_to_per_frame(pred, take_length) if pred else np.full(take_length, -1, np.int64)
            reports[f"take_{take_idx}"] = report(gts, preds, PHASE_LONG_NAMES)
            split_gts.append(gts)
            split_preds.append(preds)
        if split_gts:
            reports[split] = report(
                np.concatenate(split_gts), np.concatenate(split_preds), PHASE_LONG_NAMES
            )
    return reports
