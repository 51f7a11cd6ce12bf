"""ORDataset — scan enumeration, GT loading, caching, batching (port of
``or4d_tpu/data/dataset.py``).

Reference: `scene_graph_helpers/dataset/or_dataset.py` +
`dataset_utils.py`:
  * scans come from relationships_{train,validation,test_dummy}.json; scans
    with fewer than 3 valid-class nodes are dropped (get_relationships
    :215-256);
  * per-scan prepared samples are cached to disk (or_dataset.py:94-120);
  * for inference without GT, per-scan object lists are synthesized from
    predicted instance labels (dataset_loading :52-61);
  * loss weights come from train-split occurrence counts.

Samples are padded SceneSamples; batches are stacked SceneBatches. When the
raw capture data (pcds, instance labels) is not on disk, per-scan geometry
is synthesized deterministically from the GT object list (the reference's
own virtual-object trick, dataset_utils.py:96-115, generalized) unless
``synthetic_fallback`` is False, which raises instead.

The sample cache's default base directory is the port's own
(``{tempdir}/or4d_torch_cache``), so the port never reads a sample the JAX
package wrote. With ``IMAGE_INPUT == "full"`` each sample carries its six
camera frames (:mod:`or4d_tpu_torch.data.images`), loaded after the cache
fetch as the reference does; MULTI_REL_OUTPUTS samples carry multi-hot
``gt_rels``.
"""

from __future__ import annotations

import json
import os
import tempfile
import zlib
from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import TAKE_SPLIT, DatasetConfig, ExperimentConfig
from or4d_tpu_torch.data import ingest
from or4d_tpu_torch.data.prep import prepare_scene
from or4d_tpu_torch.data.scene_batch import SceneBatch, SceneSample
from or4d_tpu_torch.data.synthetic import make_raw_scene
from or4d_tpu_torch.data.vocab import Vocab
from or4d_tpu_torch.data.weights import compute_weights

_SPLIT_FILES = {
    "train": "relationships_train.json",
    "val": "relationships_validation.json",
    "test": "relationships_test_dummy.json",
}
_CACHED_FIELDS = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class",
                  "gt_rels", "obj_mask", "edge_mask", "rel_hand_points")


def default_cache_dir() -> Path:
    """The port's sample-cache base directory under the temp directory."""
    return Path(tempfile.gettempdir()) / "or4d_torch_cache"


def load_relationship_scans(root: str | Path, split: str) -> list[dict]:
    """Load the split's scans list; [] when the json is absent.

    For test, real annotations (relationships_test.json) are preferred over
    the dummy stand-in when present (the reference's dataset_utils.py:44-46
    TODO made actionable)."""
    candidates = [_SPLIT_FILES[split]]
    if split == "test":
        candidates.insert(0, "relationships_test.json")
    for name in candidates:
        p = Path(root) / name
        if p.exists():
            return json.loads(p.read_text())["scans"]
    return []


def filter_scans(scans: list[dict], vocab: Vocab, split: str, max_objects: int) -> list[dict]:
    """get_relationships semantics: right take split, >= 3 valid nodes."""
    out = []
    for scan in scans:
        if scan["take_idx"] not in TAKE_SPLIT[split]:
            continue
        valid = sum(1 for v in scan["objects"].values() if v in vocab.class_names)
        if valid < 3 or valid > max_objects:
            continue
        out.append(scan)
    return out


def synthesize_scan_geometry(scan: dict, rng: np.random.Generator, points_per_obj: int = 3000):
    """Deterministic synthetic geometry for a GT scan entry: one gaussian
    blob per object + background, instance-labeled."""
    objs = {int(k): v for k, v in scan["objects"].items()}
    pts, inst = [], []
    hands = {}
    for inst_id, name in sorted(objs.items()):
        center = rng.uniform(-2.0, 2.0, size=3)
        npts = int(points_per_obj * rng.uniform(0.5, 1.5))
        xyz = center + rng.normal(scale=0.35, size=(npts, 3))
        rgb = np.clip(rng.uniform(0, 1, size=3) + rng.normal(scale=0.05, size=(npts, 3)), 0, 1)
        pts.append(np.concatenate([xyz, rgb], axis=1))
        inst.append(np.full(npts, inst_id))
        if "human" in name or name == "Patient":
            hands[inst_id] = center + rng.normal(scale=0.4, size=(2, 3))
    nbg = points_per_obj
    pts.append(np.concatenate([rng.uniform(-3, 3, size=(nbg, 3)), rng.uniform(0, 1, size=(nbg, 3))], axis=1))
    inst.append(np.zeros(nbg))
    return np.concatenate(pts).astype(np.float32), np.concatenate(inst).astype(np.int32), objs, hands


class ORDataset:
    """Scan-level dataset with on-disk sample caching and batching."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        split: str,
        vocab: Vocab,
        data_root: str | Path = "data",
        cache_dir: str | Path | None = None,
        for_eval: bool = False,
        synthetic_fallback: bool = True,
        synthetic_scans_per_take: int = 32,
        pair_shared: bool | None = None,
    ):
        self.cfg = cfg
        self.ds: DatasetConfig = cfg.dataset
        self.split = split
        self.vocab = vocab
        self.for_eval = for_eval
        # eval samples share each union crop across the two directions of a
        # pair (direction-invariant by reference construction, data/prep.py)
        # so the eval forward can use the paired rel-encoder path; train keeps
        # independent per-edge draws (direction-dependent augmentation)
        self.pair_shared = for_eval if pair_shared is None else pair_shared
        self.data_root = Path(data_root)
        suffix = (
            self.ds.dataset_suffix + ("" if cfg.use_gt else "_no_gt")
            + ("_eval" if for_eval else "") + ("_paired" if self.pair_shared else "")
            + ("_multirel" if cfg.model.multi_rel_outputs else "")
        )
        # an explicit cache_dir is a BASE dir: the config-dependent suffix
        # still applies so gt/no-gt/eval variants never collide
        base = Path(cache_dir) if cache_dir else default_cache_dir()
        self.cache_dir = base / f"scene_graph_cache{suffix}"
        self.cache_dir.mkdir(parents=True, exist_ok=True)

        scans = load_relationship_scans(self.data_root, split)
        if for_eval and not cfg.use_gt:
            # dataset_loading(:52-61): object lists for no-GT inference come
            # from the predicted instance labels, relationships are dropped
            for scan in scans:
                pred_path = ingest.instance_labels_path(self.data_root, scan["take_idx"], scan["scan"], pred=True)
                if pred_path.exists():
                    scan["objects"] = {
                        str(k): v
                        for k, v in ingest.synthesize_objects_from_pred_labels(
                            self.data_root, scan["take_idx"], scan["scan"]
                        ).items()
                    }
                    scan["relationships"] = []
        scans = filter_scans(scans, vocab, split, self.ds.max_objects)
        self.synthetic_scan_list = False
        if not scans and synthetic_fallback:
            scans = self._synthetic_scan_list(synthetic_scans_per_take)
            self.synthetic_scan_list = True
        self.scans = scans
        self._human_joints_cache: dict = {}
        if not self.scans:
            raise RuntimeError(f"no scans for split {split} under {self.data_root}")
        # loud data provenance: a partially present real dataset must never
        # silently train/evaluate on fabricated geometry (see sample()'s
        # per-scan has_raw_scan fallback)
        self.synthetic_fallback = synthetic_fallback
        self.n_real = sum(
            1 for s in self.scans
            if not self.synthetic_scan_list
            and ingest.has_raw_scan(self.data_root, s["take_idx"], s["scan"], cfg.use_gt)
        )
        self.n_synthetic = len(self.scans) - self.n_real
        origin = "SYNTHETIC scan list (no relationships json)" if self.synthetic_scan_list else (
            f"{self.n_real} real / {self.n_synthetic} synthetic-geometry scans"
        )
        print(f"ORDataset[{split}, {cfg.name}]: {len(self.scans)} scans — {origin}")
        if not synthetic_fallback and self.n_synthetic:
            example = next(
                s for s in self.scans
                if not ingest.has_raw_scan(self.data_root, s["take_idx"], s["scan"], cfg.use_gt)
            )
            raise RuntimeError(
                f"synthetic_fallback=False but {self.n_synthetic} scans have no raw "
                f"geometry under {self.data_root} (e.g. take {example['take_idx']} "
                f"scan {example['scan']})"
            )

    def _synthetic_scan_list(self, per_take: int) -> list[dict]:
        """GT-format scan entries drawn from a seeded generator — used when
        the split's relationships json is not shipped (e.g. train)."""
        out = []
        for take_idx in TAKE_SPLIT[self.split]:
            for i in range(per_take):
                rng = np.random.default_rng(take_idx * 100_000 + i)
                n_obj = int(rng.integers(4, min(10, self.ds.max_objects) + 1))
                _, _, objs, rels, _ = make_raw_scene(rng, n_objects=n_obj, points_per_obj=16)
                out.append(
                    {
                        "take_idx": take_idx,
                        "scan": f"{i:06d}",
                        "objects": {str(k): v for k, v in objs.items()},
                        "relationships": rels,
                        "human_idx_to_name": {},
                    }
                )
        return out

    def __len__(self) -> int:
        return len(self.scans)

    def weights(self):
        """Train-split loss weights (get_weights path)."""
        return compute_weights(self.vocab, self.scans)

    def _human_joints(self, take_idx) -> dict | None:
        """Per-take wrist-joint source, cached (or_dataset.py:83-91; the
        reference always reads the GT_True artifact and skips the test split)."""
        if self.split == "test":
            return None
        if take_idx not in self._human_joints_cache:
            self._human_joints_cache[take_idx] = ingest.load_human_joints(self.data_root, take_idx, from_gt=True)
        return self._human_joints_cache[take_idx]

    def _attach_images(self, sample: SceneSample, scan: dict) -> SceneSample:
        """IMAGE_INPUT == 'full': the six-camera stack rides outside the npz
        cache, loaded per access like the reference (or_dataset.py:128-129
        adds ``full_image`` after the cached sample is fetched). A take
        without exported colour frames gets the JAX package's deterministic
        random stack (the same numpy draw), so the multimodal path runs
        end to end on synthetic data."""
        if self.cfg.image_input != "full":
            return sample
        from or4d_tpu_torch.data import images as img_mod

        size = self.cfg.model.image_size
        if img_mod.has_images(self.data_root, scan["take_idx"]):
            sample.images = img_mod.load_full_image_data(self.data_root, scan["take_idx"], scan["scan"],
                                                         image_size=size).numpy()
        else:
            rng = np.random.default_rng(zlib.crc32(f"img_{sample.scan_id}".encode()))
            sample.images = rng.normal(size=(img_mod.NUM_CAMERAS, size, size, 3)).astype(np.float32)
        return sample

    def sample(self, index: int, points_per_obj: int = 3000) -> SceneSample:
        scan = self.scans[index]
        # scan ids carry the split index suffix like the reference
        # (get_relationships: f'{take}_{scan}_{split}'), which flows into the
        # scan_relations json keys (predict_relations uses the scan ids)
        split_idx = {"train": 0, "val": 1, "test": 2}[self.split]
        scan_id = f"{scan['take_idx']}_{scan['scan']}_{split_idx}"
        cache_path = self.cache_dir / f"{scan_id}.npz"
        if cache_path.exists():
            with np.load(cache_path, allow_pickle=True) as data:
                meta = data["meta"].item()
                cached = SceneSample(
                    **{k: data[k] for k in _CACHED_FIELDS},
                    scan_id=meta["scan_id"],
                    take_idx=meta["take_idx"],
                    slot_names=tuple(meta["slot_names"]),
                )
            return self._attach_images(cached, scan)
        # stable across processes (hash() is PYTHONHASHSEED-salted) so cached
        # samples are reproducible
        rng = np.random.default_rng(zlib.crc32(scan_id.encode()))
        if ingest.has_raw_scan(self.data_root, scan["take_idx"], scan["scan"], self.cfg.use_gt):
            objs = {int(k): v for k, v in scan["objects"].items()}
            points, instances, hands = ingest.load_scan_geometry(
                self.data_root, scan["take_idx"], scan["scan"], objs,
                use_gt=self.cfg.use_gt, for_infer=self.for_eval,
                human_joints=self._human_joints(scan["take_idx"]), rng=rng,
            )
        else:
            points, instances, objs, hands = synthesize_scan_geometry(scan, rng, points_per_obj)
        rels = [list(r) for r in scan.get("relationships", [])]
        sample = prepare_scene(
            points, instances, objs, rels, self.vocab, self.ds, rng,
            hand_locations=hands, scan_id=scan_id, take_idx=scan["take_idx"],
            pair_shared=self.pair_shared, multi_rel=self.cfg.model.multi_rel_outputs,
        )
        # written under a name of this process's own, then renamed: the ranks
        # of a data-parallel run prepare the same scans side by side
        tmp = cache_path.with_name(f"{cache_path.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                **{k: getattr(sample, k) for k in _CACHED_FIELDS},
                meta={"scan_id": sample.scan_id, "take_idx": sample.take_idx, "slot_names": list(sample.slot_names)},
            )
        os.replace(tmp, cache_path)
        return self._attach_images(sample, scan)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0, limit: int | None = None):
        """Yield SceneBatches of ``batch_size`` scenes (last batch smaller)."""
        order = np.arange(len(self.scans))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if limit:
            order = order[:limit]
        for i in range(0, len(order), batch_size):
            samples = [self.sample(int(j)) for j in order[i : i + batch_size]]
            yield SceneBatch.stack(samples)
