"""Serving-mode evaluation: precomputed SA1 geometry (port of
``or4d_tpu/serving.py``, single device).

For a fixed, non-augmented evaluation set the geometry of the point encoders'
first stage depends only on each crop's xyz, never on the weights: the FPS
centroids and the ball-query neighbourhoods. It is computed once per batch:

* ``new_xyz``: the SA1 FPS centroids of every crop row (the FPS kernel);
* per SA1 scale, the grouped ``[p_abs | f]`` rows of every (centroid, slot)
  in the first-hit-filled neighbourhood (the multi-scale ball-query kernel,
  then gathers), stored in the model's compute dtype.

Every later evaluation runs SA1 as its MLP chain on the cached planes (the
serving SA1 kernel) and SA2/SA3 as in cold eval; the crops are not read. The
reference validates the whole val split every epoch
(scene_graph_prediction/main.py:62-66) and serves fixed takes offline: that
is this access pattern.

Cache layout (the port's own): planes (R, M, ns, 8) with channels
zero-padded to 8 (``SA1Cache.c0`` keeps the true count), so one slot is one
aligned 16-byte load in bfloat16. The TPU package's slot-flattened
channel-major layout exists for Mosaic's lanes and is not carried over.

Command line (random seeded weights, synthetic unpaired scenes)::

    python -m or4d_tpu_torch.serving --synthetic --config no_gt|tiny --scenes S \\
        [--cache-dir D] [--device cpu]

prints ``{"split": "synthetic", "relation_macro_f1": f}``; it runs on the
card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
from or4d_tpu_torch.ops.ball_query_multiscale import ball_query_multiscale
from or4d_tpu_torch.ops.fps import furthest_point_sample
from or4d_tpu_torch.ops.serving_sa1_mlp import C0P
from or4d_tpu_torch.train.metrics import RelationMetricAccumulator
from or4d_tpu_torch.utils.stream import lookahead

# the persisted layout: (R, M, ns, 8) planes; bump when it changes
LAYOUT = "torch-rows-slots-c8-v1"
_GATHER_ELEMS = 1 << 26  # bound on the cache build's per-chunk gather temporaries


@dataclasses.dataclass
class SA1Cache:
    """One row set's SA1 geometry: centroids and, per scale, the grouped
    layer-0 planes (R, M, ns, 8) whose first ``c0`` channels are
    ``[xyz | features]`` and the rest zero."""

    new_xyz: torch.Tensor  # (R, M, 3) float32
    grouped: tuple[torch.Tensor, ...]  # per scale (R, M, ns, 8), compute dtype
    c0: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.new_xyz, *self.grouped))

    def to(self, device, non_blocking: bool = False) -> "SA1Cache":
        return SA1Cache(self.new_xyz.to(device, non_blocking=non_blocking),
                        tuple(g.to(device, non_blocking=non_blocking) for g in self.grouped), self.c0)


def build_sa1_cache(pc: torch.Tensor, npoint: int, scales, dtype=torch.float32) -> SA1Cache:
    """The geometry of crops ``pc`` (R, P, C), C <= 8: FPS centroids, the
    multi-scale ball query, then the grouped ``[xyz | features]`` rows cast
    to ``dtype`` (the cold path casts the same values at each MLP entry).
    Centroids stay float32."""
    R, _P, c0 = pc.shape
    if c0 > C0P:
        raise ValueError(f"crops of at most {C0P} channels, got {c0}")
    rows = pc.float().contiguous()  # [xyz | features] in f32
    xyz = rows[..., :3].contiguous()
    idx = furthest_point_sample(xyz, npoint)
    new_xyz = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    grouped = []
    for (_r, ns), qidx in zip(scales, ball_query_multiscale(scales, xyz, new_xyz)):
        M = qidx.shape[1]
        g = torch.zeros(R, M, ns, C0P, dtype=dtype, device=pc.device)
        step = max(1, _GATHER_ELEMS // max(M * ns * c0, 1))
        for r0 in range(0, R, step):
            q = qidx[r0 : r0 + step].long()
            b = q.shape[0]
            sel = torch.gather(rows[r0 : r0 + step], 1, q.reshape(b, M * ns, 1).expand(-1, -1, c0))
            g[r0 : r0 + step, ..., :c0] = sel.view(b, M, ns, c0).to(dtype)
        grouped.append(g)
    return SA1Cache(new_xyz=new_xyz, grouped=tuple(grouped), c0=c0)


def sa1_geometry(encoder) -> tuple[int, tuple[tuple[float, int], ...]]:
    """(npoint, ((radius, nsample), ...)) of an encoder's SA1 stage."""
    sa1 = encoder.sa1
    return sa1.npoint, tuple((sc.radius, sc.nsample) for sc in sa1.scales)


def build_sgpn_sa1_caches(model, batch: SceneBatch, pack: SlotPack | None = None) -> tuple[SA1Cache, SA1Cache]:
    """(obj_cache, rel_cache) for an SGPN eval batch on the model's device,
    in the row order the encoders see: the flat pack's compacted rows, or
    every slot without a pack. Paired packs are refused."""
    if pack is not None and pack.paired:
        raise ValueError("serving caches are built for unpaired packs (SA1 is skipped entirely)")
    S, O, Po, Co = batch.obj_points.shape
    _, E, Pr, Cr = batch.rel_points.shape
    obj_flat = batch.obj_points.reshape(S * O, Po, Co)
    rel_flat = batch.rel_points.reshape(S * E, Pr, Cr)
    if pack is not None:
        obj_flat, rel_flat = obj_flat[pack.obj_idx], rel_flat[pack.edge_idx]
    dtype = model.compute_dtype
    return (build_sa1_cache(obj_flat, *sa1_geometry(model.obj_encoder), dtype),
            build_sa1_cache(rel_flat, *sa1_geometry(model.rel_encoder), dtype))


def _cache_key(batch: SceneBatch, model) -> str:
    """Content key of a persisted cache: scan identity, padded shapes,
    validity masks, both encoders' SA1 geometry (npoint, radii, nsamples),
    the storage dtype and the layout tag. Crop content is assumed to be a
    function of the scan ids (true of the non-augmented data pipeline); a
    changed prep recipe needs a fresh cache directory."""
    b = batch.numpy()
    h = hashlib.sha256()
    h.update(repr((
        tuple(b.scan_ids), tuple(int(t) for t in b.take_idxs), tuple(b.obj_points.shape),
        tuple(b.rel_points.shape), sa1_geometry(model.obj_encoder), sa1_geometry(model.rel_encoder),
        str(model.compute_dtype), LAYOUT,
    )).encode())
    h.update(np.ascontiguousarray(b.obj_mask).tobytes())
    h.update(np.ascontiguousarray(b.edge_mask).tobytes())
    return h.hexdigest()[:24]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host array and its dtype name; bfloat16 as uint16 bit patterns
    (numpy has no bfloat16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if str(t.dtype).replace("torch.", "") != dtype:
        raise ValueError(f"stored array of {t.dtype}, meta says {dtype}")
    return t


def _save_caches(path, caches: tuple[SA1Cache, SA1Cache]) -> None:
    """Persist an (obj, rel) cache pair as one uncompressed npz, written to
    a temporary name and renamed, with a JSON meta entry (layout, c0,
    dtypes)."""
    arrays, meta = {}, {"layout": LAYOUT}
    for prefix, c in (("obj", caches[0]), ("rel", caches[1])):
        arrays[f"{prefix}_new_xyz"], _ = _to_numpy(c.new_xyz)
        meta[f"{prefix}_n"] = len(c.grouped)
        meta[f"{prefix}_c0"] = int(c.c0)
        for i, g in enumerate(c.grouped):
            arrays[f"{prefix}_g{i}"], meta[f"{prefix}_g{i}"] = _to_numpy(g)
    arrays["meta"] = np.array(json.dumps(meta))
    path = Path(path)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _load_caches(path) -> tuple[SA1Cache, SA1Cache]:
    """Inverse of :func:`_save_caches`; CPU tensors."""
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("layout") != LAYOUT:
            raise ValueError(f"{path}: cache layout {meta.get('layout')!r}, this code reads {LAYOUT!r}")

        def one(prefix):
            grouped = tuple(_from_numpy(z[f"{prefix}_g{i}"], meta[f"{prefix}_g{i}"])
                            for i in range(int(meta[f"{prefix}_n"])))
            return SA1Cache(new_xyz=torch.from_numpy(z[f"{prefix}_new_xyz"]), grouped=grouped,
                            c0=int(meta[f"{prefix}_c0"]))

        return one("obj"), one("rel")


def _strip_points(batch: SceneBatch) -> SceneBatch:
    """The batch with 1-point stand-ins for the crops: the serving path reads
    only their shapes (S, O/E, channels), and at paper shapes the relation
    crops alone are ~2 GB per 64-scene batch."""
    S, O, _, Co = batch.obj_points.shape
    _, E, _, Cr = batch.rel_points.shape
    return dataclasses.replace(batch, obj_points=np.zeros((S, O, 1, Co), np.float32),
                               rel_points=np.zeros((S, E, 1, Cr), np.float32))


def _to_host(caches: tuple[SA1Cache, SA1Cache]) -> tuple[SA1Cache, SA1Cache]:
    """Caches in host memory, pinned where a card is present (so uploads
    can run without blocking the host)."""
    out = []
    for c in caches:
        c = c.to("cpu")
        if torch.cuda.is_available():
            c = SA1Cache(c.new_xyz.pin_memory(), tuple(g.pin_memory() for g in c.grouped), c.c0)
        out.append(c)
    return tuple(out)


class ServingEvaluator:
    """Repeated evaluation of a fixed batch list with the trainer's model:
    the SA1 caches are built once (or loaded from ``cache_dir``), then every
    :meth:`evaluate` runs the serving path.

    ``offload``: keep caches in host memory and upload each batch's cache
    inside :meth:`evaluate`; ``"auto"`` offloads once the resident caches
    pass ``device_budget_bytes`` (about 2 GB per 64-scene bfloat16 batch at
    paper shapes), deciding inside the build loop so residency never passes
    the budget by more than one batch's cache.

    ``cache_dir``: one npz per batch, named by a content key
    (:func:`_cache_key`); a restart loads the planes instead of building.

    Entries of ``batches`` are ``[batch, pack, caches, offloaded, labels]``:
    the batch with 1-point crops and its flat pack on the device, the
    caches, whether they are in host memory, and the host copy of the batch
    the metrics read.
    """

    def __init__(self, trainer, batches, offload: bool | str = "auto", device_budget_bytes: int = 4 << 30,
                 cache_dir=None):
        if cache_dir is not None:
            cache_dir = Path(cache_dir)
            cache_dir.mkdir(parents=True, exist_ok=True)
        self.trainer = trainer
        model, dev = trainer.model, trainer.device
        self.batches = []
        offload_now = offload is True
        resident = 0
        with torch.no_grad():
            for batch in batches:
                host = batch.numpy()
                pack = SlotPack.build(host).to(dev)
                cache_file = cache_dir / f"sa1_{_cache_key(host, model)}.npz" if cache_dir is not None else None
                if cache_file is not None and cache_file.exists():
                    caches = _load_caches(cache_file)  # host; placed below
                else:
                    caches = build_sgpn_sa1_caches(model, host.to(dev), pack)
                    if cache_file is not None:
                        _save_caches(cache_file, caches)
                labels = _strip_points(host)
                if not offload_now and offload == "auto":
                    resident += sum(c.nbytes for c in caches)
                    if resident > device_budget_bytes:
                        offload_now = True
                        for entry in self.batches:
                            entry[2], entry[3] = _to_host(entry[2]), True
                caches = _to_host(caches) if offload_now else tuple(c.to(dev) for c in caches)
                self.batches.append([labels.to(dev), pack, caches, offload_now, labels])

    def evaluate(self, verbose: bool = False) -> float:
        """Relation macro F1 over the batches (the metric of record)."""
        acc = RelationMetricAccumulator(list(self.trainer.vocab.relation_names))
        model, dev = self.trainer.model, self.trainer.device

        def dispatch(entry):
            batch, pack, caches, offloaded, labels = entry
            if offloaded:
                caches = tuple(c.to(dev, non_blocking=True) for c in caches)
            rel = model(batch, pack, sa1_caches=caches).rel_logprobs
            if rel.device.type != "cuda":
                return labels, rel, None
            host = torch.empty(rel.shape, dtype=rel.dtype, pin_memory=True)
            host.copy_(rel, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return labels, host, done

        def consume(work):
            labels, rel, done = work
            if done is not None:
                done.synchronize()
            acc.update_batch(labels, rel)

        # one-batch lookahead: batch i+1's upload and forward are queued
        # before batch i's log-probs are read, so at most two batches'
        # caches are on the card at once
        with torch.no_grad():
            lookahead(self.batches, dispatch, consume)
        if verbose:
            for take, report in acc.per_take_reports().items():
                print(f"\nTake {take}\n{report.to_text()}")
        return acc.macro_f1


def main(argv: list[str] | None = None) -> dict:
    from or4d_tpu_torch.config import load_config
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.device import resolve_device
    from or4d_tpu_torch.train.loop import Trainer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", action="store_true", help="synthetic unpaired scenes (the only input so far)")
    p.add_argument("--config", default="no_gt", help="no_gt (paper shapes) or tiny (smoke shapes)")
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache-dir", default=None, help="persist the SA1 caches here (one npz per batch)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not args.synthetic:
        p.error("only --synthetic input is ported so far")

    cfg = load_config(args.config)
    vocab = DEFAULT_VOCAB
    paper = args.config == "no_gt"
    samples = make_scene_samples(args.scenes, seed=args.seed, n_objects=9 if paper else 6, ds=cfg.dataset,
                                 points_per_obj=2000 if paper else 150)
    trainer = Trainer(cfg, vocab, np.ones(vocab.num_classes, np.float32), np.ones(vocab.num_relations, np.float32),
                      device=device, seed=args.seed)
    S = cfg.tpu.scene_batch
    batches = [SceneBatch.stack(samples[i : i + S]) for i in range(0, len(samples), S)]
    f1 = ServingEvaluator(trainer, batches, cache_dir=args.cache_dir).evaluate()
    rec = {"split": "synthetic", "relation_macro_f1": f1}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
