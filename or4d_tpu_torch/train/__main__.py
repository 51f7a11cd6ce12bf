"""Train SGPN on synthetic labeled scenes.

    python -m or4d_tpu_torch.train --synthetic --config no_gt|tiny --scenes S --steps K \
        [--device cpu] [--checkpoint-dir D] [--serving [--serving-cache-dir D]] --output history.json

Runs on the card unless ``--device cpu`` is given, and raises without one.
Batches of the config's ``scene_batch`` scenes cycle until K steps are
done; class weights come from the scenes' labels. With ``--checkpoint-dir``
the latest checkpoint there is restored first and one is saved at the end.
The output JSON holds each step's losses and seconds and the relation macro
F1 of the final weights on the training scenes; with ``--serving`` that F1
goes through a ``ServingEvaluator`` (SA1 geometry cached, optionally
persisted in ``--serving-cache-dir``).
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch


def main(argv: list[str] | None = None) -> dict:
    from or4d_tpu_torch.config import load_config
    from or4d_tpu_torch.data.scene_batch import SceneBatch
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.data.weights import sample_counts, weights_from_counts
    from or4d_tpu_torch.device import resolve_device
    from or4d_tpu_torch.train import checkpoint as ckpt
    from or4d_tpu_torch.train.loop import Trainer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--synthetic", action="store_true", help="synthetic labeled scenes (the only input here)")
    p.add_argument("--config", default="no_gt", help="no_gt (paper shapes) or tiny (smoke shapes)")
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--serving", action="store_true", help="evaluate the final weights on cached SA1 geometry")
    p.add_argument("--serving-cache-dir", default=None, help="persist the serving caches here")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not args.synthetic:
        p.error("only --synthetic input here; for a data root use python -m or4d_tpu_torch.cli")

    cfg = load_config(args.config)
    vocab = DEFAULT_VOCAB
    paper = args.config == "no_gt"
    samples = make_scene_samples(args.scenes, seed=args.seed, n_objects=9 if paper else 6, ds=cfg.dataset,
                                 points_per_obj=2000 if paper else 150)
    w_obj, w_rel = weights_from_counts(vocab, *sample_counts(vocab, samples))
    trainer = Trainer(cfg, vocab, w_obj, w_rel, device=device, seed=args.seed)
    if args.checkpoint_dir and ckpt.latest_step(args.checkpoint_dir) is not None:
        trainer.step = ckpt.restore(args.checkpoint_dir, trainer.model, trainer.optimizer)
        print(f"restored step {trainer.step} from {args.checkpoint_dir}")
    S = cfg.tpu.scene_batch
    batches = [SceneBatch.stack(samples[i : i + S]) for i in range(0, len(samples), S)]
    gen = torch.Generator().manual_seed(args.seed + trainer.step)
    history = []
    for k in range(args.steps):
        t0 = time.perf_counter()
        parts = trainer.train_step(batches[k % len(batches)], gen)
        rec = {"step": trainer.step, **{n: float(v) for n, v in parts.items()}, "seconds": time.perf_counter() - t0}
        history.append(rec)
        print(json.dumps(rec), flush=True)
    if args.checkpoint_dir:
        ckpt.save(args.checkpoint_dir, trainer.model, trainer.optimizer, trainer.step)
    if args.serving:
        from or4d_tpu_torch.serving import ServingEvaluator

        f1 = ServingEvaluator(trainer, batches, cache_dir=args.serving_cache_dir).evaluate()
    else:
        f1 = trainer.evaluate(batches)
    result = {"config": args.config, "device": str(device), "scenes": args.scenes, "history": history,
              "train_macro_f1": f1}
    if not all(math.isfinite(r["loss"]) for r in history):
        raise RuntimeError(f"non-finite loss in {history}")
    Path(args.output).write_text(json.dumps(result, indent=1))
    print(f"wrote {args.output} ({len(history)} steps, {cfg.tpu.compute_dtype} on {device})")
    return result


if __name__ == "__main__":
    main()
