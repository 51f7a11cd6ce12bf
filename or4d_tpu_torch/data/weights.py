"""Class-frequency loss weights (a numpy copy of ``or4d_tpu/data/weights.py``).

Reference: occurrence counting in
`scene_graph_prediction/data_processing/compute_weight_occurrences.py:26-102`
and the weighting rules in `dataset_utils.py:get_weights:259-289`:
  * objects: |1 / (log(count) + 1)|  (log-inverse)
  * relations: 1 / count             (linear-inverse)
  * weight of 'none' forced to 1e-4.
"""

from __future__ import annotations

import numpy as np

from or4d_tpu_torch.data.vocab import Vocab


def count_occurrences(vocab: Vocab, scans: list[dict], selected_scan_ids: set[str] | None = None):
    """Count object-class and relation occurrences over relationship scans.

    ``scans``: entries in the relationships_*.json 'scans' format
    (take_idx, scan, objects {id: name}, relationships [[sub, obj, rel_id, rel_name]]).
    """
    obj_counts = np.zeros(vocab.num_classes)
    rel_counts = np.zeros(vocab.num_relations)
    for scan in scans:
        scan_id = f"{scan['take_idx']}_{scan['scan']}"
        if selected_scan_ids is not None and scan_id not in selected_scan_ids:
            continue
        for _, name in scan["objects"].items():
            if name in vocab.class_names:
                obj_counts[vocab.class_index(name)] += 1
        for rel in scan["relationships"]:
            rel_name = rel[3]
            if rel_name in vocab.relation_names:
                rel_counts[vocab.relation_index(rel_name)] += 1
    return obj_counts, rel_counts


def sample_counts(vocab: Vocab, samples) -> tuple[np.ndarray, np.ndarray]:
    """The same counts over prepared scenes (SceneSample): the valid object
    slots' classes and the valid edges' relations other than 'none' (the
    relationship jsons list no 'none' relations)."""
    obj_counts = np.zeros(vocab.num_classes)
    rel_counts = np.zeros(vocab.num_relations)
    for s in samples:
        np.add.at(obj_counts, np.asarray(s.gt_class)[np.asarray(s.obj_mask, bool)], 1)
        rels = np.asarray(s.gt_rels)[np.asarray(s.edge_mask, bool)]
        np.add.at(rel_counts, rels[rels != vocab.none_index], 1)
    return obj_counts, rel_counts


def weights_from_counts(vocab: Vocab, obj_counts: np.ndarray, rel_counts: np.ndarray):
    """(w_obj (num_classes,), w_rel (num_relations,)) float32 by the
    reference's rules."""
    with np.errstate(divide="ignore"):
        w_obj = np.abs(1.0 / (np.log(obj_counts) + 1.0))
        w_rel = 1.0 / rel_counts
    # classes/relations never seen: torch gives inf here too; clamp to 0 so
    # they cannot contribute loss (they also never appear as targets)
    w_obj = np.where(np.isfinite(w_obj), w_obj, 0.0)
    w_rel = np.where(np.isfinite(w_rel), w_rel, 0.0)
    w_rel[vocab.none_index] = 1e-4  # dataset_utils.py:269
    return w_obj.astype(np.float32), w_rel.astype(np.float32)


def compute_weights(vocab: Vocab, scans: list[dict], selected_scan_ids: set[str] | None = None):
    """Loss weights with the reference's exact rules.

    Returns (w_obj (num_classes,), w_rel (num_relations,)) float32.
    """
    return weights_from_counts(vocab, *count_occurrences(vocab, scans, selected_scan_ids))
