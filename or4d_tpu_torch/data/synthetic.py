"""Synthetic labeled OR scenes for tests and benchmarks.

The reference synthesizes labeled geometry itself when objects are missing
(virtual instrument box / emulated cones, dataset_utils.py:96-115); this
module generalizes that trick into a full synthetic-scene fixture: gaussian
blob point clouds per object, GT relations drawn from the vocabulary, hand
locations near human blobs. Deterministic per (seed, scan).

Port of ``or4d_tpu/data/synthetic.py``.
"""

from __future__ import annotations

import numpy as np

from or4d_tpu_torch.config import DatasetConfig
from or4d_tpu_torch.data.prep import prepare_scene
from or4d_tpu_torch.data.scene_batch import SceneBatch, SceneSample
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB, Vocab


def make_raw_scene(rng: np.random.Generator, n_objects: int = 6, points_per_obj: int = 3000):
    """Random labeled cloud: (points (N,6), instances (N,), objs, rels, hands)."""
    vocab = DEFAULT_VOCAB
    # always include the core furniture + humans, then extras
    base = ["operating_table", "Patient", "human_0", "instrument_table", "anesthesia_equipment", "instrument"]
    extra = ["human_1", "human_2", "secondary_table", "human_3", "human_4", "human_5"]
    names = (base + extra)[: max(3, n_objects)]

    pts, inst = [], []
    objs: dict[int, str] = {}
    centers = {}
    for i, name in enumerate(names):
        inst_id = i + 1
        objs[inst_id] = name
        center = rng.uniform(-2.0, 2.0, size=3)
        centers[inst_id] = center
        npts = int(points_per_obj * rng.uniform(0.5, 1.5))
        xyz = center + rng.normal(scale=0.35, size=(npts, 3))
        rgb = np.clip(rng.uniform(0, 1, size=3) + rng.normal(scale=0.05, size=(npts, 3)), 0, 1)
        pts.append(np.concatenate([xyz, rgb], axis=1))
        inst.append(np.full(npts, inst_id))
    # background clutter
    nbg = points_per_obj
    bg = np.concatenate([rng.uniform(-3, 3, size=(nbg, 3)), rng.uniform(0, 1, size=(nbg, 3))], axis=1)
    pts.append(bg)
    inst.append(np.zeros(nbg))

    points = np.concatenate(pts).astype(np.float32)
    instances = np.concatenate(inst).astype(np.int32)

    # GT relations as deterministic functions of the geometry, so a trained
    # model can actually generalize to unseen synthetic scenes:
    #   CloseTo   <- center distance below threshold (symmetric-ish)
    #   LyingOn   <- human roughly above a table (small horizontal offset)
    #   Holding   <- human near the instrument
    #   Preparing <- human near the anesthesia equipment
    rels = []

    def add(a, b, rel_name):
        rels.append([int(a), int(b), vocab.relation_index(rel_name), rel_name])

    ids = list(objs)
    is_human = {i: ("human" in objs[i] or objs[i] == "Patient") for i in ids}
    for a in ids:
        for b in ids:
            if a == b:
                continue
            ca, cb = centers[a], centers[b]
            d = float(np.linalg.norm(ca - cb))
            horiz = float(np.linalg.norm(ca[[0, 2]] - cb[[0, 2]]))
            if is_human[a] and "table" in objs[b] and horiz < 0.9 and ca[1] > cb[1]:
                add(a, b, "LyingOn")
            elif is_human[a] and objs[b] == "instrument" and d < 1.4:
                add(a, b, "Holding")
            elif is_human[a] and objs[b] == "anesthesia_equipment" and d < 1.6:
                add(a, b, "Preparing")
            elif d < 1.2:
                add(a, b, "CloseTo")

    hands = {}
    for inst_id, name in objs.items():
        if "human" in name or name == "Patient":
            hands[inst_id] = centers[inst_id] + rng.normal(scale=0.4, size=(2, 3))
    return points, instances, objs, rels, hands


def make_scene_sample(
    seed: int = 0,
    n_objects: int = 6,
    ds: DatasetConfig | None = None,
    vocab: Vocab | None = None,
    points_per_obj: int = 3000,
    take_idx: int = 1,
    scan_idx: int = 0,
    pair_shared: bool = False,
    multi_rel: bool = False,
    image_size: int | None = None,
) -> SceneSample:
    """``image_size``: the sample carries six random normal camera frames of
    that side (drawn after the scene, from the same generator)."""
    ds = ds or DatasetConfig()
    vocab = vocab or DEFAULT_VOCAB
    rng = np.random.default_rng(seed)
    points, instances, objs, rels, hands = make_raw_scene(rng, n_objects, points_per_obj)
    sample = prepare_scene(
        points, instances, objs, rels, vocab, ds, rng,
        hand_locations=hands, scan_id=f"{take_idx}_{scan_idx:06d}", take_idx=take_idx,
        pair_shared=pair_shared, multi_rel=multi_rel,
    )
    if image_size:
        sample.images = rng.standard_normal((6, image_size, image_size, 3), dtype=np.float32)
    return sample


def make_scene_samples(num_scenes: int = 2, seed: int = 0, n_objects: int = 6, ds: DatasetConfig | None = None, **kw) -> list[SceneSample]:
    return [make_scene_sample(seed + i, n_objects=n_objects, ds=ds, scan_idx=i, **kw) for i in range(num_scenes)]


def make_scene_batch(num_scenes: int = 2, seed: int = 0, n_objects: int = 6, ds: DatasetConfig | None = None, **kw) -> SceneBatch:
    return SceneBatch.stack(make_scene_samples(num_scenes, seed, n_objects, ds, **kw))
