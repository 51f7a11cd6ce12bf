"""Heuristic clinical-role prediction over scene-graph tracks.

Reference: `role_prediction/heuristic_based_role_prediction.py` — a weighted
evidence accumulator per human track followed by greedy unique role
assignment per frame. Deterministic host-side logic (not a tensor workload),
kept faithfully rule-for-rule:

  * evidence weights (check_rels :67-147): LyingOn op-table => Patient x10;
    surgical actions applied TO the target => Patient x10; applied BY the
    target => head_surgeon x10; anesthesia-equipment ops => anaesthetist x50;
    ... plus the tie-breaking epsilon ladder;
  * guess normalization when total > 1 (calculate_guesses_for_tracks);
  * greedy assignment: highest score first, claimed role zeroed everywhere
    (infer_roles_in_sg :238-270);
  * pred->GT human matching by joint L2 (match_human_preds_to_gt :295-312).

Role JSON output format: {"{take}_{scan}": {human_name: role}} matching
rule_based_role_predictions_*.json (:392-393).

A numpy copy of ``or4d_tpu/pipeline/roles_heuristic.py`` for the PyTorch port.
"""

from __future__ import annotations

import json
from collections import defaultdict
from copy import deepcopy
from pathlib import Path

import numpy as np

ROLE_LABEL_NAMES = ["Patient", "head_surgeon", "assistant_surgeon", "circulating_nurse", "anaesthetist"]

# fixed fallback scores for tracks without a model score
# (role_prediction_helpers.py:236-238)
DEFAULT_GUESS = {
    "Patient": 0.0003,
    "head_surgeon": 0.0001,
    "assistant_surgeon": 0.0002,
    "circulating_nurse": 0.0005,
    "anaesthetist": 0.0004,
}

_SURGICAL_ACTIONS_ON_PATIENT = ["Cementing", "Cutting", "Drilling", "Hammering", "Sawing", "Suturing", "Cleaning", "Preparing"]
_SURGICAL_ACTIONS_BY_SURGEON = ["Cementing", "Cutting", "Drilling", "Hammering", "Sawing", "Suturing"]


def humanize(name: str) -> str:
    return "human" if ("human" in name or "Patient" in name) else name


def scene_graph_to_readable(scan_rels: dict) -> list[tuple[str, str, str]]:
    """GT-format scan entry -> (sub_name, rel, obj_name) with humans collapsed
    (convert_scene_graph_to_human_readable :15-27)."""
    objects = scan_rels["objects"]
    out = []
    for sub_idx, obj_idx, rel_idx, rel_name in scan_rels["relationships"]:
        out.append((humanize(objects[str(sub_idx)]), rel_name, humanize(objects[str(obj_idx)])))
    return out


def _count(rels, sub=None, rel=None, obj=None) -> float:
    n = 0
    for s, r, o in rels:
        if sub is not None and s != sub:
            continue
        if rel is not None and r != rel:
            continue
        if obj is not None and o != obj:
            continue
        n += 1
    return float(n)


def score_track(rels: list[tuple[str, str, str]]) -> dict[str, float]:
    """check_rels: accumulate weighted role evidence for one track's TARGET
    relations, then normalize if the total exceeds 1."""
    g = defaultdict(float)
    g["Patient"] += _count(rels, sub="TARGET", rel="LyingOn", obj="operating_table") * 10
    g["Patient"] += sum(_count(rels, rel=a, obj="TARGET") for a in _SURGICAL_ACTIONS_ON_PATIENT) * 10
    g["head_surgeon"] += sum(_count(rels, rel=a, sub="TARGET") for a in _SURGICAL_ACTIONS_BY_SURGEON) * 10
    anesthesia = _count(rels, sub="TARGET", rel="Operating", obj="anesthesia_equipment") + _count(
        rels, sub="TARGET", rel="Touching", obj="anesthesia_equipment"
    )
    g["anaesthetist"] += anesthesia * 50

    touching = _count(rels, sub="TARGET", rel="Touching", obj="human")
    g["head_surgeon"] += touching * 5
    g["assistant_surgeon"] += touching

    assisting = _count(rels, sub="TARGET", rel="Assisting", obj="human")
    g["assistant_surgeon"] += assisting * 10
    g["circulating_nurse"] += assisting

    getting_assisted = _count(rels, sub="human", rel="Assisting", obj="TARGET") / 2
    g["head_surgeon"] += getting_assisted * 4
    g["assistant_surgeon"] += getting_assisted

    cleaning = _count(rels, sub="TARGET", rel="Cleaning", obj="human")
    g["assistant_surgeon"] += cleaning * 10
    g["head_surgeon"] += cleaning * 5

    preparing = _count(rels, sub="TARGET", rel="Preparing", obj="human")
    g["assistant_surgeon"] += preparing * 5
    g["head_surgeon"] += preparing * 5
    g["circulating_nurse"] += preparing * 2
    g["anaesthetist"] += preparing

    op_table_operating = _count(rels, sub="TARGET", rel="Operating", obj="operating_table")
    g["anaesthetist"] += op_table_operating * 10
    g["circulating_nurse"] += op_table_operating * 10

    instr_table = _count(rels, sub="TARGET", rel="Touching", obj="instrument_table") + _count(
        rels, sub="TARGET", rel="CloseTo", obj="instrument_table"
    )
    g["assistant_surgeon"] += instr_table * 3
    g["circulating_nurse"] += instr_table * 1

    sec_table = _count(rels, sub="TARGET", rel="Touching", obj="secondary_table") + _count(
        rels, sub="TARGET", rel="CloseTo", obj="secondary_table"
    )
    g["circulating_nurse"] += sec_table * 8
    g["anaesthetist"] += sec_table * 1

    holding = _count(rels, sub="TARGET", rel="Holding", obj="instrument")
    g["head_surgeon"] += holding * 5
    g["assistant_surgeon"] += holding * 4
    g["circulating_nurse"] += holding * 1

    g["anaesthetist"] += _count(rels, sub="TARGET", rel="CloseTo", obj="anesthesia_equipment")

    op_table_close = _count(rels, sub="TARGET", rel="CloseTo", obj="operating_table")
    g["head_surgeon"] += op_table_close
    g["assistant_surgeon"] += op_table_close

    # epsilon ladder for deterministic ordering with no evidence
    g["circulating_nurse"] += 0.005
    g["anaesthetist"] += 0.004
    g["Patient"] += 0.003
    g["assistant_surgeon"] += 0.002
    g["head_surgeon"] += 0.001

    total = sum(g.values())
    if total > 1.0:
        g = defaultdict(float, {k: v / total for k, v in g.items()})
    return dict(g)


def collect_track_relations(track: dict, frame_to_relations: dict[str, list], use_gt_format: bool = False) -> list:
    """get_track_rels for one track: gather the TARGET-renamed relations of
    every frame the track appears in."""
    rels = []
    for frame_str, (h_name, _joints) in track["timestamp_to_human_pose"].items():
        frame_rels = frame_to_relations.get(frame_str)
        if frame_rels is None:
            continue
        for r in deepcopy([list(x) for x in frame_rels]):
            sub, rel, obj = r
            if sub == h_name:
                sub = "TARGET"
            elif obj == h_name:
                obj = "TARGET"
            if sub == "TARGET" or obj == "TARGET":
                rels.append((humanize(sub) if sub != "TARGET" else sub, rel, humanize(obj) if obj != "TARGET" else obj))
    return rels


def assign_roles_in_frame(frame_str: str, tracks: list[dict], track_scores: dict[int, dict[str, float]]):
    """infer_roles_in_sg: greedy unique assignment by confidence; a claimed
    role is zeroed for the remaining tracks."""
    candidates = {}
    for track_idx, track in enumerate(tracks):
        if frame_str in track["timestamp_to_human_pose"]:
            # unscored tracks get the reference's fixed default guess
            # (role_prediction_helpers.py:236-238)
            candidates[track_idx] = deepcopy(track_scores.get(track_idx, DEFAULT_GUESS))
    humans_to_roles: dict[str, str] = {}
    humans_to_joints: dict[str, np.ndarray] = {}
    while candidates:
        best_track, best_role, best_score = None, None, -1.0
        for track_idx, guesses in candidates.items():
            role, score = max(guesses.items(), key=lambda x: x[1])
            if score > best_score:
                best_track, best_role, best_score = track_idx, role, score
        h_name, joints = tracks[best_track]["timestamp_to_human_pose"][frame_str]
        humans_to_roles[h_name] = best_role
        humans_to_joints[h_name] = joints
        for guesses in candidates.values():
            guesses[best_role] = 0.0
        del candidates[best_track]
    return humans_to_roles, humans_to_joints


def match_human_preds_to_gt(gt_humans_to_joints: dict, pred_humans_to_roles: dict, pred_humans_to_joints: dict) -> dict:
    """Greedy min-L2 matching of predicted humans to GT names
    (match_human_preds_to_gt :295-312)."""
    gt_items = sorted(gt_humans_to_joints.items())
    pred_items = sorted((k, (pred_humans_to_roles[k], pred_humans_to_joints[k])) for k in pred_humans_to_roles)
    out = {}
    while gt_items and pred_items:
        dm = np.zeros((len(gt_items), len(pred_items)))
        for i, (_, gj) in enumerate(gt_items):
            for j, (_, (_, pj)) in enumerate(pred_items):
                dm[i, j] = np.linalg.norm(np.asarray(gj) - np.asarray(pj))
        i, j = np.unravel_index(dm.argmin(), dm.shape)
        out[gt_items[i][0]] = pred_items[j][1][0]
        gt_items.pop(i)
        pred_items.pop(j)
    return out


def predict_roles_for_take(
    take_idx: int,
    tracks: list[dict],
    frame_to_relations: dict[str, list],
    track_scores: dict[int, dict[str, float]] | None = None,
) -> dict[str, dict[str, str]]:
    """Full heuristic path for one take: score tracks, then assign per frame.
    ``track_scores`` can be injected (the Graphormer path reuses the same
    assignment with learned scores)."""
    if track_scores is None:
        track_scores = {
            i: score_track(collect_track_relations(t, frame_to_relations)) for i, t in enumerate(tracks)
        }
    out = {}
    for frame_str in sorted(frame_to_relations):
        roles, _ = assign_roles_in_frame(frame_str, tracks, track_scores)
        out[f"{take_idx}_{frame_str}"] = roles
    return out


def role_name_to_index(name: str) -> int:
    """role_prediction_helpers.name_to_index (:130-140); 'none' -> 5."""
    if name == "none":
        return 5
    return ROLE_LABEL_NAMES.index(name.replace("-", "_"))


def eval_role_prediction_perf(
    gt_scans_by_take: dict[int, list[dict]],
    frame_predictions: dict[str, dict[str, str]],
    frame_pred_joints: dict[str, dict] | None = None,
    gt_joints_by_take: dict[int, dict] | None = None,
    use_gt: bool = True,
):
    """Reference eval_role_prediction_perf (role_prediction_helpers.py:142-208):
    walk each take's GT scans in scan order, look up the per-frame role
    assignment (GT-matching predicted humans by joint L2 when not use_gt),
    and report per-take + overall classification over the 5 roles
    ('none' = unpredicted).

    ``frame_predictions``: {"{take}_{frame}": {human_name: role}} — the
    interchange written by both role predictors.
    Returns (take_to_results, overall ClassReport).
    """
    from or4d_tpu_torch.train.metrics import classification_report

    take_to_results = {}
    all_gt, all_pred = [], []
    for take_idx in sorted(gt_scans_by_take):
        gt_labels, pred_labels = [], []
        for gt_sg in sorted(gt_scans_by_take[take_idx], key=lambda s: s["scan"]):
            key = f"{take_idx}_{gt_sg['scan']}"
            humans_to_roles = dict(frame_predictions.get(key, {}))
            human_idx_to_name = dict(gt_sg.get("human_idx_to_name", {}))
            if "Patient" in gt_sg["objects"].values():
                human_idx_to_name["Patient"] = "Patient"
            if not use_gt and frame_pred_joints and gt_joints_by_take:
                gt_joints = gt_joints_by_take.get(take_idx, {}).get(gt_sg["scan"], {})
                pred_joints = frame_pred_joints.get(key, {})
                if gt_joints and pred_joints:
                    humans_to_roles = match_human_preds_to_gt(gt_joints, humans_to_roles, pred_joints)
            for human_idx, role in human_idx_to_name.items():
                gt_labels.append(role_name_to_index(role))
                pred_labels.append(role_name_to_index(humans_to_roles.get(human_idx, "none")))
        if gt_labels:
            take_to_results[take_idx] = classification_report(gt_labels, pred_labels, ROLE_LABEL_NAMES)
        all_gt.extend(gt_labels)
        all_pred.extend(pred_labels)
    overall = classification_report(all_gt, all_pred, ROLE_LABEL_NAMES) if all_gt else None
    return take_to_results, overall


def write_role_json(path: str | Path, predictions: dict) -> None:
    Path(path).write_text(json.dumps(predictions))
