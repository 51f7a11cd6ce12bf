"""Structured configuration system for the whole framework.

One config system replaces the reference's five coexisting styles (JSON via
json_tricks in scene_graph_prediction/main.py:17-21, python constants in
helpers/configurations.py, argparse, yacs, hydra — SURVEY.md §5). Configs are
frozen dataclasses that (a) load from the reference's JSON schema unchanged
(`scene_graph_helpers/configs/no_gt.json`, `no_gt_image.json`) and (b) carry
the execution knobs the reference never had (padding maxima, precision).

A copy of the config classes of ``or4d_tpu/config.py`` for the PyTorch port,
which imports nothing of the JAX package. Of the TPU execution knobs only the
three that change results are kept.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any


# ---------------------------------------------------------------------------
# dataset-level constants (reference: helpers/configurations.py:29-61)
# ---------------------------------------------------------------------------

OBJECT_LABEL_MAP: dict[str, int] = {
    "anesthesia_equipment": 0,
    "operating_table": 1,
    "instrument_table": 2,
    "secondary_table": 3,
    "instrument": 4,
    "object": 5,
    "Patient": 9,
    "human_0": 10,
    "human_1": 11,
    "human_2": 12,
    "human_3": 13,
    "human_4": 14,
    "human_5": 15,
    "human_6": 16,
    "human_7": 17,
}

TAKE_SPLIT: dict[str, list[int]] = {"train": [1, 3, 5, 7, 9, 10], "val": [4, 8], "test": [2, 6]}

DEPTH_SCALING = 2000

# 14-joint skeleton (reference: helpers/configurations.py:65-97)
LIMBS: list[list[int]] = [
    [5, 4], [9, 7], [7, 3], [2, 6], [6, 8], [5, 3], [4, 2],
    [3, 1], [2, 1], [1, 0], [10, 4], [11, 5], [12, 10], [13, 11],
]

IDX_TO_BODY_PART = [
    "head", "neck", "leftshoulder", "rightshoulder", "lefthip", "righthip",
    "leftelbow", "rightelbow", "leftwrist", "rightwrist", "leftknee",
    "rightknee", "leftfoot", "rightfoot",
]

STATIONARY_OBJECTS = ["instrument_table", "secondary_table"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The MODEL block of the reference JSON configs."""

    n_layers: int = 2
    with_bn: bool = False
    use_gcn: bool = True
    obj_pred_from_gcn: bool = True
    input_dropout: float = 0.0
    gcn_type: str = "TRIP"
    point_feature_size: int = 256
    edge_feature_size: int = 256
    gcn_hidden_feature_size: int = 512
    lambda_o: float = 1e-6
    full_image_embedding_size: int = 768
    image_model: str | bool = False
    # side length fed to the image trunk; 456 is tf_efficientnet_b5_ns's
    # resolved input size (timm data config), overridable for CI shapes
    image_size: int = 456
    multi_rel_outputs: bool = False
    # encoder SA centroid/sample counts (reference 512/128, (16,32)/(32,64));
    # overridable for scaled-down CI shapes
    sa_npoints: tuple = (512, 128)
    sa_nsamples: tuple = ((16, 32), (32, 64))

    @classmethod
    def from_reference_json(cls, m: dict[str, Any]) -> "ModelConfig":
        return cls(
            n_layers=m.get("N_LAYERS", 2),
            with_bn=m.get("WITH_BN", False),
            use_gcn=m.get("USE_GCN", True),
            obj_pred_from_gcn=m.get("OBJ_PRED_FROM_GCN", True),
            input_dropout=m.get("INPUT_DROPOUT", 0.0),
            gcn_type=m.get("GCN_TYPE", "TRIP"),
            point_feature_size=m.get("point_feature_size", 256),
            edge_feature_size=m.get("edge_feature_size", 256),
            gcn_hidden_feature_size=m.get("gcn_hidden_feature_size", 512),
            lambda_o=float(m.get("lambda_o", 1e-6)),
            full_image_embedding_size=m.get("FULL_IMAGE_EMBEDDING_SIZE", 768),
            image_model=m.get("IMAGE_MODEL", False),
            image_size=m.get("IMAGE_SIZE", 456),
            # the reference configs' key (the JAX package's loader leaves it at False)
            multi_rel_outputs=m.get("MULTI_REL_OUTPUTS", False),
            # TPU-build extension keys (absent from reference configs):
            # scaled-down encoder shapes for smoke/CI runs
            sa_npoints=tuple(m.get("sa_npoints", (512, 128))),
            sa_nsamples=tuple(tuple(s) for s in m.get("sa_nsamples", ((16, 32), (32, 64)))),
        )


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """The dataset block + TPU padding maxima.

    The reference runs batch_size=1 with ragged object/edge counts
    (main.py:54, data_preparation_utils.py:110-137); here every scene is
    padded to (max_objects, max_edges) so scenes batch and shard.
    """

    root: str = "data"
    data_augmentation: bool = True
    num_points_objects: int = 4000
    num_points_relation: int = 8000
    num_points_scene: int = 10000
    dataset_suffix: str = ""
    # TPU padding maxima: 4D-OR scenes have 4-11 objects (relationships
    # jsons), so 12 objects / 12*11 edges cover every scan.
    max_objects: int = 12
    max_edges: int = 132

    @classmethod
    def from_reference_json(cls, d: dict[str, Any]) -> "DatasetConfig":
        root = d.get("root", ["data"])
        return cls(
            root=root[0] if isinstance(root, list) else root,
            data_augmentation=d.get("data_augmentation", True),
            num_points_objects=d.get("num_points_objects", 4000),
            num_points_relation=d.get("num_points_relation", 8000),
            num_points_scene=d.get("num_points_scene", 10000),
            dataset_suffix=d.get("DATASET_SUFFIX", ""),
        )


@dataclasses.dataclass(frozen=True)
class TPUConfig:
    """Execution knobs of the reference package that change results: the
    scene batch, the compute dtype, ``train_raw`` and ``remat``.

    ``train_raw`` picks SA1's train grouping on supports wider than one
    512-point chunk: True groups rows built from the raw [xyz|features]
    plane (TPU row 5; W0's gradient accumulated in f32 inside the kernel,
    no gradient to the input features), False groups rows of the layer-1
    plane A (TPU row 9; dA rounded to the compute dtype before
    dW0 = x^T @ dA, and the features get their gradient through A). Its
    sort, gate and packing knobs (``packed_slots``, ``per_scale_sort``,
    ``eval_subtile``, ``train_per_scale_sort``) only change speed on a TPU
    and have no counterpart here."""

    scene_batch: int = 8           # scenes per global step (reference: 1)
    compute_dtype: str = "float32"  # "bfloat16" for the matmul-heavy path
    train_raw: bool = True         # or4d_tpu/config.py:172
    # recompute the SA stages' BN/ReLU/dense chains in the backward instead
    # of saving them (exact; the JAX package's selective remat,
    # or4d_tpu/config.py:152): what lets an S=8 float32 step at the
    # largest batch (12 objects, 132 edges a scene) fit on an 80 GB card
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Top level, mirroring the reference JSON root keys."""

    name: str = "no_gt"
    max_epochs: int = 25
    lr: float = 3e-5
    w_decay: float = 1e-3
    use_gt: bool = False
    image_input: str | bool = False
    weighting: bool = True
    seed: int = 42
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    tpu: TPUConfig = dataclasses.field(default_factory=TPUConfig)

    @classmethod
    def from_reference_json(cls, path_or_dict: str | Path | dict[str, Any], name: str | None = None) -> "ExperimentConfig":
        """Load a reference-format config (e.g. no_gt.json) unchanged."""
        if isinstance(path_or_dict, (str, Path)):
            p = Path(path_or_dict)
            raw = json.loads(_strip_json_comments(p.read_text()))
            name = name or p.stem
        else:
            raw = dict(path_or_dict)
            name = name or raw.get("NAME", "config")
        tpu_raw = raw.get("TPU", {})
        ds = DatasetConfig.from_reference_json(raw.get("dataset", {}))
        if "TPU" in raw:
            ds = dataclasses.replace(
                ds,
                max_objects=tpu_raw.get("max_objects", ds.max_objects),
                max_edges=tpu_raw.get("max_edges", ds.max_edges),
            )
        return cls(
            name=name,
            max_epochs=raw.get("MAX_EPOCHES", 25),
            lr=float(raw.get("LR", 3e-5)),
            w_decay=float(raw.get("W_DECAY", 1e-3)),
            use_gt=raw.get("USE_GT", False),
            image_input=raw.get("IMAGE_INPUT", False),
            weighting=raw.get("WEIGHTING", True),
            model=ModelConfig.from_reference_json(raw.get("MODEL", {}) if isinstance(raw.get("MODEL"), dict) else {}),
            dataset=ds,
            tpu=TPUConfig(**{k.lower(): v for k, v in tpu_raw.items() if k.lower() in {f.name for f in dataclasses.fields(TPUConfig)}}),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _strip_json_comments(text: str) -> str:
    """The reference loads configs with json_tricks ignore_comments=True."""
    out_lines = []
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("//") or stripped.startswith("#"):
            continue
        out_lines.append(line)
    return "\n".join(out_lines)


# The two paper configs, embedded (reference: scene_graph_helpers/configs/*)
NO_GT = ExperimentConfig(name="no_gt")
NO_GT_IMAGE = dataclasses.replace(
    NO_GT,
    name="no_gt_image",
    image_input="full",
    model=dataclasses.replace(NO_GT.model, image_model="tf_efficientnet_b5_ns"),
)

# scaled-down config for smoke runs / CI — same architecture, small shapes
TINY = ExperimentConfig(
    name="tiny",
    max_epochs=2,
    lr=1e-3,
    model=ModelConfig(sa_npoints=(32, 16), sa_nsamples=((4, 8), (8, 8))),
    dataset=DatasetConfig(
        num_points_objects=128, num_points_relation=192, max_objects=6, max_edges=30, data_augmentation=False
    ),
    tpu=TPUConfig(scene_batch=4),
)


def load_config(name_or_path: str) -> ExperimentConfig:
    """Resolve a config by embedded name or file path."""
    builtin = {"no_gt": NO_GT, "no_gt_image": NO_GT_IMAGE, "tiny": TINY}
    key = name_or_path.replace(".json", "")
    if key in builtin and not Path(name_or_path).exists():
        return builtin[key]
    return ExperimentConfig.from_reference_json(name_or_path)
