"""Training and evaluation loop (port of ``or4d_tpu/train/loop.py``, single device).

One train step: augment the batch (when the config asks for it), run SGPN in
train mode over a flat unpaired ``SlotPack``, take the mask-weighted NLL
(``sgpn_loss``), backpropagate and apply AdamW (``lr``, ``w_decay``, betas
0.9/0.999, eps 1e-8 — optax's ``adamw`` defaults, every trainable parameter
decayed); with the image branch its frozen trunk (everything but
``conv_head`` and ``reduction``) is outside the optimizer, no update and no
decay, as ``optax.set_to_zero`` gives it in the JAX package
(or4d_tpu/train/loop.py:68-77); the BN running statistics are updated in place during the forward. Eval
steps run under ``torch.no_grad()`` with a paired pack for pair-shared
batches.

Random draws (augmentation, head dropout) come from the ``torch.Generator``
the caller passes, on the CPU, so a step on the card and one on the CPU
with equal generators draw the same numbers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from or4d_tpu_torch.config import ExperimentConfig
from or4d_tpu_torch.data.augment import augment_batch_with, draw_augment
from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack, is_pair_shared
from or4d_tpu_torch.data.vocab import Vocab
from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.models.sgpn import SGPN, sgpn_loss
from or4d_tpu_torch.train.metrics import RelationMetricAccumulator


class Trainer:
    """Owns the model, the optimizer and the step count. The model is made
    from ``seed`` on ``device`` (default ``cuda``; raises without a card
    unless ``device="cpu"``)."""

    def __init__(self, cfg: ExperimentConfig, vocab: Vocab, weights_obj, weights_rel, device=None, seed: int = 0):
        self.cfg, self.vocab = cfg, vocab
        self.device = resolve_device(device)
        self.model = SGPN.from_config(cfg, vocab.num_classes, vocab.num_relations, device=self.device, seed=seed)
        self.optimizer = torch.optim.AdamW(self.trainable_parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.w_decay)
        self.w_obj = torch.as_tensor(np.asarray(weights_obj, np.float32), device=self.device)
        self.w_rel = torch.as_tensor(np.asarray(weights_rel, np.float32), device=self.device)
        self.step = 0
        self.last_rel_logprobs: torch.Tensor | None = None

    def trainable_parameters(self) -> list[torch.nn.Parameter]:
        """The parameters AdamW updates (``efficientnet.is_trainable``)."""
        from or4d_tpu_torch.models.efficientnet import is_trainable

        return [p for n, p in self.model.named_parameters() if is_trainable(n)]

    def train_step(self, batch: SceneBatch, generator: torch.Generator | None = None, *,
                   augment_draws=None, dropout_keep: dict | None = None) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; returns {"loss", "loss_obj",
        "loss_rel"} (detached 0-d tensors). ``augment_draws``
        (:class:`AugmentDraws`) and ``dropout_keep`` replace the draws from
        ``generator``."""
        host = batch.numpy()
        pack = SlotPack.build(host).to(self.device)
        b = host.to(self.device)
        if self.cfg.dataset.data_augmentation:
            S, O = b.obj_points.shape[:2]
            draws = augment_draws or draw_augment(S, O, b.rel_points.shape[1], generator)
            b = augment_batch_with(b, draws.to(self.device))
        out = self.model(b, pack, train=True, generator=generator, dropout_keep=dropout_keep)
        loss, parts = sgpn_loss(out, b, self.w_obj, self.w_rel, self.cfg.model.lambda_o)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for p in self.optimizer.param_groups[0]["params"]:
            if p.grad is None:  # optax updates (decays) every trainable parameter
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        self.last_rel_logprobs = out.rel_logprobs.detach()
        return {k: v.detach() for k, v in parts.items()}

    @torch.no_grad()
    def eval_step(self, batch: SceneBatch):
        """(rel_logprobs (S, E, R), obj_logprobs (S, O, C)) on the device;
        pair-shared batches encode each unordered relation pair once."""
        host = batch.numpy()
        pack = SlotPack.build(host, paired=is_pair_shared(host)).to(self.device)
        out = self.model(host.to(self.device), pack)
        return out.rel_logprobs, out.obj_logprobs

    def evaluate(self, batches, verbose: bool = False) -> float:
        """Relation macro F1 over every batch (the metric of record)."""
        acc = RelationMetricAccumulator(list(self.vocab.relation_names))
        for batch in batches:
            acc.update_batch(batch.numpy(), self.eval_step(batch)[0])
        if verbose:
            for take, report in acc.per_take_reports().items():
                print(f"\nTake {take}\n{report.to_text()}")
            print(f"\nOverall:\n{acc.overall_report().to_text()}")
        return acc.macro_f1

    def predict_relations(self, batches) -> dict[str, list]:
        from or4d_tpu_torch.infer import predict_relations

        return predict_relations(self.model, batches, self.vocab)

    def fit(self, train_batches, val_batches=None, epochs: int | None = None,
            generator: torch.Generator | None = None, log_every: int = 100, checkpoint_dir: str | None = None,
            serving_val: bool = False, log_dir: str | None = None):
        """Epoch loop with per-take metric accumulation (reference
        training_epoch_end/validation_epoch_end); a checkpoint per epoch
        when ``checkpoint_dir``. Returns the per-epoch history.

        ``log_dir``: a :class:`~or4d_tpu_torch.utils.logging.MetricsLogger`
        named after the config writes, per epoch, the record and
        ``steps_per_sec`` (the mean over the last 50 steps), the per-take
        train P/R/F1 and the train classification report, as the JAX
        package's ``fit`` does.

        ``serving_val``: the per-epoch validation goes through one
        :class:`~or4d_tpu_torch.serving.ServingEvaluator` built before the
        loop, so the val split's weight-independent SA1 geometry is computed
        once instead of every epoch."""
        from collections import deque

        from or4d_tpu_torch.train import checkpoint as ckpt

        logger = None
        if log_dir:
            from or4d_tpu_torch.utils.logging import MetricsLogger

            logger = MetricsLogger(log_dir, name=self.cfg.name)
        step_seconds = deque(maxlen=50)
        server = None
        if serving_val and val_batches is not None:
            from or4d_tpu_torch.serving import ServingEvaluator

            server = ServingEvaluator(self, list(val_batches))
        epochs = epochs or self.cfg.max_epochs
        generator = generator if generator is not None else torch.Generator().manual_seed(self.cfg.seed)
        train_batches = list(train_batches)
        history = []
        for epoch in range(epochs):
            acc = RelationMetricAccumulator(list(self.vocab.relation_names))
            losses = []
            t0 = time.perf_counter()
            for i, batch in enumerate(train_batches):
                t1 = time.perf_counter()
                parts = self.train_step(batch, generator)
                losses.append(float(parts["loss"]))
                step_seconds.append(time.perf_counter() - t1)
                acc.update_batch(batch.numpy(), self.last_rel_logprobs)
                if log_every and i % log_every == 0:
                    print(f"epoch {epoch} step {i}: loss={losses[-1]:.4f}")
            record = {"epoch": epoch, "train_loss": float(np.mean(losses)), "train_macro_f1": acc.macro_f1,
                      "seconds": time.perf_counter() - t0}
            if val_batches is not None:
                record["val_macro_f1"] = server.evaluate() if server is not None else self.evaluate(val_batches)
            history.append(record)
            print(f"epoch {epoch}: {record}")
            if logger:
                logged = {k: v for k, v in record.items() if k != "seconds"}
                rate = len(step_seconds) / sum(step_seconds) if step_seconds else 0.0
                logger.log(epoch, **logged, steps_per_sec=rate)
                logger.log_per_take(epoch, "train", acc.per_take_reports())
                logger.log_report("train_report", epoch, acc.overall_report().to_text())
            if checkpoint_dir:
                ckpt.save(checkpoint_dir, self.model, self.optimizer, self.step)
        if logger:
            logger.close()
        return history
