"""Fixed-shape scene containers (port of ``or4d_tpu/data/scene_batch.py``).

A scene is padded once to (max_objects, max_edges) static shapes so scenes
stack into one batch; masks carry validity. Batches and packing plans are
built on the host in numpy and moved to a device with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class SceneSample:
    """One padded scene (host-side numpy).

    Shapes (O = max_objects, E = max_edges, Po/Pr = points per obj/rel crop):
      obj_points   (O, Po, 6)  xyz (zero-mean/unit-sphere) + rgb
      rel_points   (E, Pr, 7)  xyz + rgb + mask channel (1=subject, 2=object)
      edge_index   (E, 2)      (src, dst) object-slot indices; 0 on padding
      rel_onehot   (E, 12)     subject/object coarse-type one-hots, late-fused
      gt_class     (O,)        object class ids; 0 on padding
      gt_rels      (E,)        relation ids; none_index on padding
                   (E, R)      multi-hot float32 when MULTI_REL_OUTPUTS
      obj_mask     (O,)        bool
      edge_mask    (E,)        bool
      rel_hand_points (E, 2, 3) wrist locations in the rel crop frame
      images       (6, H, W, 3) float32 camera frames when IMAGE_INPUT == "full"
    """

    obj_points: np.ndarray
    rel_points: np.ndarray
    edge_index: np.ndarray
    rel_onehot: np.ndarray
    gt_class: np.ndarray
    gt_rels: np.ndarray
    obj_mask: np.ndarray
    edge_mask: np.ndarray
    rel_hand_points: np.ndarray
    scan_id: str = ""
    take_idx: int = 0
    # slot -> object name, for the scan_relations JSON
    slot_names: tuple[str, ...] = ()
    images: Any = None


# array fields stacked into the batch, in order
_ARRAY_FIELDS = (
    "obj_points", "rel_points", "edge_index", "rel_onehot",
    "gt_class", "gt_rels", "obj_mask", "edge_mask", "rel_hand_points",
)


def _np(a: Any) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    """numpy -> torch on ``device``; integer arrays become int64 (index
    tensors), everything else keeps its dtype."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype.kind in "iu":
        t = t.long()
    return t.to(device)


@dataclasses.dataclass
class SceneBatch:
    """A stack of S padded scenes. Every array gains a leading scene axis;
    metadata (scan ids, slot names) stays on the host. ``images`` (S, 6, H,
    W, 3) float32, or None without the image branch."""

    obj_points: Any
    rel_points: Any
    edge_index: Any
    rel_onehot: Any
    gt_class: Any
    gt_rels: Any
    obj_mask: Any
    edge_mask: Any
    rel_hand_points: Any
    images: Any = None
    scan_ids: tuple[str, ...] = ()
    take_idxs: tuple[int, ...] = ()
    slot_names: tuple[tuple[str, ...], ...] = ()

    @classmethod
    def stack(cls, samples: list[SceneSample]) -> "SceneBatch":
        arrays = {f: np.stack([getattr(s, f) for s in samples]) for f in _ARRAY_FIELDS}
        images = None
        if samples[0].images is not None:
            images = np.stack([_np(s.images) for s in samples])
        return cls(
            **arrays,
            images=images,
            scan_ids=tuple(s.scan_id for s in samples),
            take_idxs=tuple(s.take_idx for s in samples),
            slot_names=tuple(s.slot_names for s in samples),
        )

    @property
    def num_scenes(self) -> int:
        return self.obj_points.shape[0]

    def pad_scenes(self, multiple: int) -> "SceneBatch":
        """The scene axis padded to a multiple with zero scenes (masks all
        False, images zero), which the masked loss, BN and metrics ignore."""
        b = self.numpy()
        pad = (-b.num_scenes) % multiple
        if pad == 0:
            return b
        grow = lambda a: np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        return dataclasses.replace(b, **{f: grow(getattr(b, f)) for f in _ARRAY_FIELDS},
                                   images=None if b.images is None else grow(b.images))

    def to(self, device: str | torch.device) -> "SceneBatch":
        """The same batch with every array a tensor on ``device``."""
        device = torch.device(device)
        arrays = {f: _to_tensor(getattr(self, f), device) for f in _ARRAY_FIELDS}
        images = None if self.images is None else _to_tensor(self.images, device)
        return dataclasses.replace(self, **arrays, images=images)

    def numpy(self) -> "SceneBatch":
        """The same batch with every array a host numpy array."""
        arrays = {f: _np(getattr(self, f)) for f in _ARRAY_FIELDS}
        return dataclasses.replace(self, **arrays, images=None if self.images is None else _np(self.images))


def _pair_slots(edge_index: np.ndarray, edge_mask: np.ndarray, s: int) -> dict[tuple[int, int], int]:
    """(src, dst) -> edge slot over the valid edges of scene ``s``."""
    return {(int(a), int(b)): e for e, (a, b) in enumerate(edge_index[s]) if edge_mask[s, e]}


def _is_mask_swap(f: np.ndarray, r: np.ndarray) -> bool:
    """Crops ``f`` and ``r`` share xyz/rgb and carry swapped masks (1<->2)."""
    return bool(
        np.array_equal(f[:, :6], r[:, :6])
        and np.array_equal(np.where(f[:, 6] > 0, 3.0 - f[:, 6], 0.0), r[:, 6])
    )


def is_pair_shared(batch: SceneBatch) -> bool:
    """True when every valid edge has its reverse in the same scene and the
    first pair's crops are direction-invariant (prep pair_shared=True) — the
    precondition for SlotPack.build(paired=True)."""
    b = batch.numpy()
    eidx, emask, rp = b.edge_index, b.edge_mask, b.rel_points
    checked = False
    for s in range(emask.shape[0]):
        slot_of = _pair_slots(eidx, emask, s)
        for (a, c), e in slot_of.items():
            if (c, a) not in slot_of:
                return False
            if not checked and a < c:
                if not _is_mask_swap(rp[s, e], rp[s, slot_of[(c, a)]]):
                    return False
                checked = True
    return checked


@dataclasses.dataclass
class SlotPack:
    """Packing plan: valid object/edge slots compacted to the front.

    Built on the host from the masks so the encoders process only
    ~sum(valid) rows instead of S*max slots; results scatter back into the
    padded layout for the GCN. Capacities are bucketed (a multiple of
    ``bucket``), as in the reference package.

      obj_idx  (Co,) flat indices into S*O; obj_valid (Co,) bool
      edge_idx (Ce,) flat indices into S*E; edge_valid (Ce,) bool

    With ``paired=True`` (a batch prepared with pair_shared crops) a pair
    plan is added so the eval path encodes each unordered pair once and
    scatters both directions:

      pair_idx     (Cp,) flat edge-slot indices of the FORWARD (a<b) edges
      pair_rev_idx (Cp,) flat edge-slot indices of the matching (b,a) edges
      pair_valid   (Cp,) bool
    """

    obj_idx: Any
    obj_valid: Any
    edge_idx: Any
    edge_valid: Any
    pair_idx: Any = None
    pair_rev_idx: Any = None
    pair_valid: Any = None

    @property
    def paired(self) -> bool:
        return self.pair_idx is not None

    @classmethod
    def build(cls, batch: SceneBatch, bucket: int = 128, paired: bool = False) -> "SlotPack":
        b = batch.numpy()

        def plan(flat_idx, n_slots):
            idx = np.asarray(flat_idx, np.int64)
            cap = max(bucket, int(np.ceil(max(len(idx), 1) / bucket)) * bucket)
            cap = min(cap, n_slots)
            padded = np.zeros(cap, np.int32)
            padded[: len(idx)] = idx
            valid = np.zeros(cap, bool)
            valid[: len(idx)] = True
            return padded, valid

        om = np.asarray(b.obj_mask).reshape(-1)
        em = np.asarray(b.edge_mask).reshape(-1)
        oi, ov = plan(np.nonzero(om)[0], len(om))
        ei, ev = plan(np.nonzero(em)[0], len(em))
        if not paired:
            return cls(obj_idx=oi, obj_valid=ov, edge_idx=ei, edge_valid=ev)

        # pair plan: for every valid forward edge (a < b) find the slot of
        # its reverse (b, a) within the same scene
        eidx, emask = b.edge_index, b.edge_mask
        S, E = emask.shape
        fwd_flat, rev_flat = [], []
        for s in range(S):
            slot_of = _pair_slots(eidx, emask, s)
            for (a, c), e in slot_of.items():
                if a < c:
                    er = slot_of.get((c, a))
                    if er is None:
                        raise ValueError(f"scene {s}: edge ({a},{c}) has no reverse — not a pair-shared batch")
                    fwd_flat.append(s * E + e)
                    rev_flat.append(s * E + er)
        if fwd_flat:
            rp = np.asarray(b.rel_points).reshape(S * E, *b.rel_points.shape[2:])
            if not _is_mask_swap(rp[fwd_flat[0]], rp[rev_flat[0]]):
                raise ValueError("paired=True but rel crops are not pair-shared (prepare_scene(pair_shared=True))")
        pi, pv = plan(fwd_flat, S * E)
        pr, _ = plan(rev_flat, S * E)
        return cls(obj_idx=oi, obj_valid=ov, edge_idx=ei, edge_valid=ev,
                   pair_idx=pi, pair_rev_idx=pr, pair_valid=pv)

    def to(self, device: str | torch.device) -> "SlotPack":
        """The same plan as int64/bool tensors on ``device``."""
        device = torch.device(device)
        return SlotPack(**{
            f.name: None if getattr(self, f.name) is None else _to_tensor(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })
