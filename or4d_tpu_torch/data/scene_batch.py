"""Fixed-shape scene containers (port of ``or4d_tpu/data/scene_batch.py``).

A scene is padded once to (max_objects, max_edges) static shapes so scenes
stack into one batch; masks carry validity. Batches and packing plans are
built on the host in numpy and moved to a device with ``.to(device)``; an
eval batch moves with its host plan, ``.to(device, pack=plan)``, which sends
only the crop rows the plan reads.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
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


# The upload's counter, as the ops modules count their launches: calls that
# sent only a pack's crop rows and calls that sent every padded slot; the crop
# bytes (``obj_points``, ``rel_points``) sent and those left on the host.
UPLOAD = {"packed_calls": 0, "full_calls": 0, "bytes_sent": 0, "bytes_skipped": 0}


def _np(a: Any) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_tensor(a: Any, device: torch.device, pin: bool = False) -> torch.Tensor:
    """numpy -> torch on ``device``; integer arrays become int64 (index
    tensors), everything else keeps its dtype. ``pin``: staged in pinned
    memory and copied without blocking (:func:`_send`)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if a.dtype.kind in "iu":
        t = t.long()
    return _send(t, device, pin)


def _host_buffer(shape: tuple, dtype: torch.dtype, pin: bool) -> torch.Tensor:
    """An empty host tensor; pinned, from PyTorch's caching host allocator,
    when ``pin``."""
    return torch.empty(shape, dtype=dtype, pin_memory=pin)


def _send(t: torch.Tensor, device: torch.device, pin: bool) -> torch.Tensor:
    """Host tensor ``t`` on ``device``; with ``pin`` copied into a pinned
    buffer first and from there without blocking. The caching host allocator
    hands the buffer out again only after that copy has completed."""
    if not pin:
        return t.to(device)
    return _host_buffer(tuple(t.shape), t.dtype, True).copy_(t).to(device, non_blocking=True)


# Pieces a packed crop upload is cut into: each is copied to the card while
# the next is gathered (on an H100 host, 516 MB of rows: 31 ms gathered
# whole then copied, 25 ms in 4 pieces, 28 ms in 8).
_PIECES = 4


def _cuts(lo: int, hi: int, k: int) -> list[tuple[int, int]]:
    """[lo, hi) cut into at most ``k`` nearly equal, non-empty ranges."""
    c = np.linspace(lo, hi, max(1, min(k, hi - lo)) + 1).astype(np.int64)
    return list(zip(c[:-1].tolist(), c[1:].tolist()))


def _rows(a: Any, idx: Any, device: torch.device, pin: bool, pool: ThreadPoolExecutor,
          threads: int) -> torch.Tensor:
    """Rows ``idx`` of ``a`` (S, N, ...) with its two slot axes flattened,
    (len(idx), ...) on ``device``. ``np.take`` over the (S * N, row) view
    gathers them into a host buffer, a range of ``idx`` to each of
    ``threads`` threads of ``pool`` (``np.take`` releases the GIL;
    ``torch.index_select`` into pinned memory ran at a sixth of this speed
    on an H100 host). With ``pin`` the buffer is pinned and gathered in
    ``_PIECES`` pieces, each copied without blocking once it is whole."""
    src = _np(a)
    flat = src.reshape(src.shape[0] * src.shape[1], -1)
    idx = _np(idx).astype(np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= flat.shape[0]):
        raise IndexError(f"pack rows out of range for {flat.shape[0]} slots")
    host = _host_buffer((idx.size, flat.shape[1]), torch.from_numpy(np.empty(0, flat.dtype)).dtype, pin)
    out = torch.empty(host.shape, dtype=host.dtype, device=device) if pin else host
    dst = host.numpy()

    def take(lo: int, hi: int) -> None:
        # mode="clip" writes straight into ``dst`` ("raise" buffers); the
        # range is checked above
        np.take(flat, idx[lo:hi], axis=0, out=dst[lo:hi], mode="clip")

    for lo, hi in _cuts(0, idx.size, _PIECES if pin else 1):
        list(pool.map(lambda r: take(*r), _cuts(lo, hi, threads)))
        if pin:
            out[lo:hi].copy_(host[lo:hi], non_blocking=True)
    return out.view((idx.size,) + tuple(src.shape[2:]))


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

    def to(self, device: str | torch.device, pack: "SlotPack | None" = None) -> "SceneBatch":
        """The same batch with every array a tensor on ``device``.

        ``pack``: the plan the eval forward will run this batch with, as
        ``SlotPack.build`` makes it (a dp rank's row of a sharded one). Only
        the crop rows it reads are sent, in its order: ``obj_points``
        becomes (Co, Po, 6), the rows at ``obj_idx``, and ``rel_points``
        (Cp, Pr, 7) at ``pair_idx`` for a paired plan, else (Ce, Pr, 7) at
        ``edge_idx``; every other array keeps its padded layout, the masks
        (S, O) and (S, E) among them. To a card every array is staged in
        pinned memory (the crop rows gathered straight into it) and copied
        without blocking, so the call does not wait for the card.
        ``SGPN.forward`` takes such a batch with the same plan."""
        device = torch.device(device)
        padded_bytes = self.obj_points.nbytes + self.rel_points.nbytes
        if pack is None:
            arrays = {f: _to_tensor(getattr(self, f), device) for f in _ARRAY_FIELDS}
            images = None if self.images is None else _to_tensor(self.images, device)
            UPLOAD["full_calls"] += 1
            UPLOAD["bytes_sent"] += padded_bytes
            return dataclasses.replace(self, **arrays, images=images)
        pin = device.type == "cuda"
        rows = {"obj_points": pack.obj_idx, "rel_points": pack.pair_idx if pack.paired else pack.edge_idx}
        arrays = {f: _to_tensor(getattr(self, f), device, pin) for f in _ARRAY_FIELDS if f not in rows}
        threads = torch.get_num_threads()
        with ThreadPoolExecutor(threads) as pool:
            for f, idx in rows.items():
                arrays[f] = _rows(getattr(self, f), idx, device, pin, pool, threads)
        sent = sum(arrays[f].nbytes for f in rows)
        images = None if self.images is None else _to_tensor(self.images, device, pin)
        UPLOAD["packed_calls"] += 1
        UPLOAD["bytes_sent"] += sent
        UPLOAD["bytes_skipped"] += padded_bytes - sent
        return dataclasses.replace(self, **arrays, images=images)

    def numpy(self) -> "SceneBatch":
        """The same batch with every array a host numpy array."""
        arrays = {f: _np(getattr(self, f)) for f in _ARRAY_FIELDS}
        return dataclasses.replace(self, **arrays, images=None if self.images is None else _np(self.images))


def gather_rows_local(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The per-shard gather of a sharded plan (the JAX package's
    ``gather_rows_local``): ``flat`` (D * rows, ...) read as D blocks of
    ``rows``, ``idx`` (D, cap) local to each block -> (D * cap, ...). A rank
    gathers its own block with its row, ``flat[idx[d]]``; this is the same
    rows for all D blocks at once."""
    D = idx.shape[0]
    blocks = flat.reshape((D, flat.shape[0] // D) + tuple(flat.shape[1:]))
    return blocks[torch.arange(D, device=idx.device)[:, None], idx.long()].reshape((-1,) + tuple(flat.shape[1:]))


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

    With ``shards`` = D > 1 every array is (D, cap): row d is the plan of
    the d-th block of S / D scenes, its indices local to that block, every
    row of one bucketed capacity (the largest block's need), as the JAX
    package builds it for a dp-sharded batch; the rank at dp index d runs
    row d (:meth:`row`) on its block.
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
    def build(cls, batch: SceneBatch, bucket: int = 128, shards: int = 1, paired: bool = False) -> "SlotPack":
        b = batch.numpy()
        S = b.num_scenes
        if S % shards:
            raise ValueError(f"{S} scenes not divisible by {shards} shards")
        per = S // shards

        def plan(flat_idx, n_slots):
            """(shards, cap) local indices and validity (cap,) for one shard;
            ``flat_idx`` flat indices into the S * n_slots axis."""
            idx = np.asarray(flat_idx, np.int64)
            shard_of = idx // (per * n_slots)
            locs = [idx[shard_of == d] - d * per * n_slots for d in range(shards)]
            need = max(max(len(l) for l in locs), 1)
            cap = min(max(bucket, int(np.ceil(need / bucket)) * bucket), per * n_slots)
            padded = np.zeros((shards, cap), np.int32)
            valid = np.zeros((shards, cap), bool)
            for d, l in enumerate(locs):
                padded[d, : len(l)] = l
                valid[d, : len(l)] = True
            return (padded[0], valid[0]) if shards == 1 else (padded, valid)

        om = np.asarray(b.obj_mask)
        em = np.asarray(b.edge_mask)
        oi, ov = plan(np.nonzero(om.reshape(-1))[0], om.shape[1])
        ei, ev = plan(np.nonzero(em.reshape(-1))[0], em.shape[1])
        if not paired:
            return cls(obj_idx=oi, obj_valid=ov, edge_idx=ei, edge_valid=ev)

        # pair plan: for every valid forward edge (a < b) find the slot of
        # its reverse (b, a) within the same scene
        eidx, emask = b.edge_index, b.edge_mask
        E = emask.shape[1]
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
        pi, pv = plan(fwd_flat, E)
        pr, _ = plan(rev_flat, E)
        return cls(obj_idx=oi, obj_valid=ov, edge_idx=ei, edge_valid=ev,
                   pair_idx=pi, pair_rev_idx=pr, pair_valid=pv)

    def row(self, d: int) -> "SlotPack":
        """Row ``d`` of a sharded plan: the flat plan of the d-th block."""
        return SlotPack(**{f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[d]
                           for f in dataclasses.fields(self)})

    def to(self, device: str | torch.device) -> "SlotPack":
        """The same plan as int64/bool tensors on ``device``."""
        device = torch.device(device)
        return SlotPack(**{
            f.name: None if getattr(self, f.name) is None else _to_tensor(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })
