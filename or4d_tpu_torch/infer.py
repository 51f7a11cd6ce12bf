"""Scene-graph inference: SGPN eval -> ``scan_relations`` JSON.

:func:`predict_relations` reproduces the JAX package's
``Trainer.predict_relations`` (or4d_tpu/train/loop.py:298-330): argmax over
the relation log-probs, drop 'none', map slots to object names. A
MULTI_REL_OUTPUTS model's head gives independent sigmoid probabilities:
each relation above 0.5 is emitted (an edge may carry several or none). A
pair-shared batch is packed with a pair plan, so the relation encoder runs
once per unordered pair (``Trainer.eval_step``).

Command line (random seeded weights)::

    python -m or4d_tpu_torch.infer --synthetic --scenes 8 --output rels.json [--device cpu]

runs on the card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
from collections.abc import Iterable
from pathlib import Path

import numpy as np
import torch

from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack, is_pair_shared
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB, Vocab
from or4d_tpu_torch.models.sgpn import SGPN


@torch.no_grad()
def predict_relations(model: SGPN, batches: Iterable[SceneBatch], vocab: Vocab = DEFAULT_VOCAB) -> dict[str, list]:
    """{scan_id: [(subject, relation, object), ...]} over every batch (eval,
    no autograd graph)."""
    dev = model.device
    none_idx = vocab.none_index
    scan_relations: dict[str, list] = {}
    for batch in batches:
        batch = batch.numpy()
        pack = SlotPack.build(batch, paired=is_pair_shared(batch))
        out = model(batch.to(dev), pack.to(dev)).rel_logprobs.cpu().numpy()
        multi = model.multi_rel_outputs
        preds = None if multi else out.argmax(-1)
        for s, scan_id in enumerate(batch.scan_ids):
            names = batch.slot_names[s]
            em, ei = batch.edge_mask[s], batch.edge_index[s]
            relations = []
            for e in range(len(em)):
                if not em[e]:
                    continue
                for r in (np.nonzero(out[s, e] > 0.5)[0] if multi else [preds[s, e]]):
                    if r != none_idx:
                        relations.append((names[ei[e, 0]], vocab.relation_names[r], names[ei[e, 1]]))
            scan_relations[scan_id] = relations
    return scan_relations


def main(argv: list[str] | None = None) -> dict[str, list]:
    from or4d_tpu_torch.config import load_config
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", action="store_true", help="synthetic pair-shared scenes (the only input here)")
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--config", default="no_gt", help="no_gt (paper shapes) or tiny (smoke shapes)")
    p.add_argument("--output", required=True)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not args.synthetic:
        p.error("only --synthetic input here; for a data root use python -m or4d_tpu_torch.cli")

    cfg = load_config(args.config)
    vocab = DEFAULT_VOCAB
    model = SGPN.from_config(cfg, vocab.num_classes, vocab.num_relations, device=device)
    # bench.py's scenes at paper shapes (9 objects, 2000 points each)
    paper = args.config == "no_gt"
    samples = make_scene_samples(args.scenes, n_objects=9 if paper else 6, ds=cfg.dataset,
                                 points_per_obj=2000 if paper else 150, pair_shared=True)
    S = cfg.tpu.scene_batch
    batches = (SceneBatch.stack(samples[i : i + S]) for i in range(0, len(samples), S))
    scan_relations = predict_relations(model, batches, vocab)
    Path(args.output).write_text(json.dumps(scan_relations))
    n = sum(len(v) for v in scan_relations.values())
    print(f"wrote {args.output} ({len(scan_relations)} scans, {n} relations, {cfg.tpu.compute_dtype} on {device})")
    return scan_relations


if __name__ == "__main__":
    main()
