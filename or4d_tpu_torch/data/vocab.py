"""Class/relation vocabularies for 4D-OR.

Reference: `data/classes.txt`, `data/relationships.txt`, loaded at
`scene_graph_prediction/scene_graph_helpers/dataset/dataset_utils.py:14-21`
and sorted + 'none'-appended at dataset_utils.py:219-227 (load_data).

A copy of ``or4d_tpu/data/vocab.py`` for the PyTorch port.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

# the shipped vocab (data/classes.txt and data/relationships.txt verbatim)
DEFAULT_CLASSES = [
    "Patient",
    "anesthesia_equipment",
    "human_0",
    "human_1",
    "human_2",
    "human_3",
    "human_4",
    "human_5",
    "instrument",
    "instrument_table",
    "operating_table",
    "secondary_table",
]

DEFAULT_RELATIONS = [
    "Assisting",
    "Cementing",
    "Cleaning",
    "CloseTo",
    "Cutting",
    "Drilling",
    "Hammering",
    "Holding",
    "LyingOn",
    "Operating",
    "Preparing",
    "Sawing",
    "Suturing",
    "Touching",
]

# relation names whose point clouds get the hand-proximity augmentation
# (reference: augmentation_utils.py:50-55)
CONTACT_RELATIONS = [
    "Cementing", "Cleaning", "Cutting", "Drilling",
    "Hammering", "Sawing", "Suturing", "Touching",
]

# coarse object types for the relation head's one-hot late fusion
# (reference: data_preparation_utils.py:21-34; n_object_types=6 at
# scene_graph_prediction_model.py:35)
OBJ_TYPE_TO_INDEX = {
    "anesthesia_equipment": 0,
    "operating_table": 1,
    "instrument_table": 2,
    "secondary_table": 3,
    "instrument": 4,
    "human": 5,
}
N_OBJECT_TYPES = len(OBJ_TYPE_TO_INDEX)


def objname_to_type_index(objname: str) -> int:
    """Collapse humans/Patient to 'human' (data_preparation_utils.py:30-31)."""
    if "human" in objname or "Patient" in objname:
        objname = "human"
    return OBJ_TYPE_TO_INDEX[objname]


@dataclasses.dataclass(frozen=True)
class Vocab:
    """Sorted class/relation vocab with 'none' appended to relations
    (load_data semantics, dataset_utils.py:219-227)."""

    class_names: tuple[str, ...]
    relation_names: tuple[str, ...]

    @classmethod
    def build(cls, classes: list[str] | None = None, relations: list[str] | None = None) -> "Vocab":
        classes = sorted(set(classes or DEFAULT_CLASSES))
        relations = sorted(set(relations or DEFAULT_RELATIONS))
        if "none" not in relations:
            relations.append("none")
        return cls(tuple(classes), tuple(relations))

    @classmethod
    def from_files(cls, root: str | Path) -> "Vocab":
        root = Path(root)
        classes = [l.rstrip() for l in (root / "classes.txt").read_text().splitlines() if l.rstrip()]
        relations = [l.rstrip() for l in (root / "relationships.txt").read_text().splitlines() if l.rstrip()]
        return cls.build(classes, relations)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def num_relations(self) -> int:
        return len(self.relation_names)

    @property
    def none_index(self) -> int:
        return self.relation_names.index("none")

    def class_index(self, name: str) -> int:
        return self.class_names.index(name)

    def relation_index(self, name: str) -> int:
        return self.relation_names.index(name)


DEFAULT_VOCAB = Vocab.build()
