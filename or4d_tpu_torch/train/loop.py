"""Training and evaluation loop (port of ``or4d_tpu/train/loop.py``).

One train step: augment the batch (when the config asks for it), run SGPN in
train mode over an unpaired ``SlotPack``, take the mask-weighted NLL
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

Data parallelism: the trainer is one rank of a mesh
(:mod:`or4d_tpu_torch.parallel`), built from ``TPUConfig.mesh_data`` /
``mesh_model`` over the initialised process group (one process and no
group: a mesh of one, no collective). Every rank is handed the same global
batch and an equal generator. A step pads the scenes to a multiple of dp,
draws the augmentation and the dropout masks for the padded global batch,
takes this rank's block of scenes, of those draws and of the dropout masks
and row d of the dp-sharded pack, augments its block (the augmentation's
rounding does not depend on the batch's shape), runs the model (BN moments and loss denominators over
every rank), sums the gradients over the world and steps AdamW alike on
every rank. Eval outputs are gathered in scene order and the padded scenes
dropped. On an mp > 1 mesh no pack is used (the slot axes are sharded) and
a rank's loss is divided by mp (each mp rank runs the GCN and the heads on
the same scenes).
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
from or4d_tpu_torch.models.heads import draw_keep
from or4d_tpu_torch.models.sgpn import SGPN, sgpn_loss
from or4d_tpu_torch.parallel.mesh import Mesh, all_reduce_, dp_block, gather, make_mesh, replicated
from or4d_tpu_torch.train.metrics import RelationMetricAccumulator
from or4d_tpu_torch.utils.profiling import StepTimer


class Trainer:
    """Owns the model, the optimizer, the mesh and the step count. The
    model is made from ``seed`` on ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``). ``mesh`` defaults to the one
    the config names (:func:`~or4d_tpu_torch.parallel.make_mesh`); on more
    than one rank every rank starts from rank 0's parameters."""

    def __init__(self, cfg: ExperimentConfig, vocab: Vocab, weights_obj, weights_rel, device=None, seed: int = 0,
                 mesh: Mesh | None = None):
        self.cfg, self.vocab = cfg, vocab
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.tpu.mesh_data, cfg.tpu.mesh_model)
        self.model = SGPN.from_config(cfg, vocab.num_classes, vocab.num_relations, device=self.device, seed=seed)
        replicated(self.mesh, self.model)
        self.model.set_mesh(self.mesh)
        self.optimizer = torch.optim.AdamW(self.trainable_parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=cfg.w_decay)
        self.w_obj = torch.as_tensor(np.asarray(weights_obj, np.float32), device=self.device)
        self.w_rel = torch.as_tensor(np.asarray(weights_rel, np.float32), device=self.device)
        self.step = 0
        self.last_rel_logprobs: torch.Tensor | None = None
        self._warned_mp_pack = False

    def trainable_parameters(self) -> list[torch.nn.Parameter]:
        """The parameters AdamW updates (``efficientnet.is_trainable``)."""
        from or4d_tpu_torch.models.efficientnet import is_trainable

        return [p for n, p in self.model.named_parameters() if is_trainable(n)]

    def _pack_for(self, padded: SceneBatch, paired: bool = False) -> SlotPack | None:
        """This rank's slot pack of a batch padded to a multiple of dp: row d
        of the dp-sharded plan (the flat plan at dp = 1), on the device.
        None on an mp > 1 mesh: its slot axes are sharded, and a compaction
        over slots would mix them."""
        mesh = self.mesh
        if mesh.mp > 1:
            if not self._warned_mp_pack:
                print(
                    "WARNING: slot packing is disabled on mp>1 meshes — padded "
                    "object/edge slots run through the encoders (~45% extra work "
                    "at paper shapes). Prefer dp-only meshes for this model; its "
                    "slot axes are small enough that mp adds communication, not "
                    "memory headroom (train/loop.py:_pack_for)."
                )
                self._warned_mp_pack = True
            return None
        if mesh.dp == 1:
            return SlotPack.build(padded, paired=paired).to(self.device)
        return SlotPack.build(padded, shards=mesh.dp, paired=paired).row(mesh.dp_rank).to(self.device)

    def _gather_scenes(self, t: torch.Tensor, S: int) -> torch.Tensor:
        """Every dp rank's block of a per-scene output, in scene order, the
        padded scenes dropped."""
        return gather(t, self.mesh.dp_group)[:S]

    def train_step(self, batch: SceneBatch, generator: torch.Generator | None = None, *,
                   augment_draws=None, dropout_keep: dict | None = None) -> dict[str, torch.Tensor]:
        """One optimizer step on the global ``batch``; returns {"loss",
        "loss_obj", "loss_rel"} of the global batch (detached 0-d tensors).
        ``augment_draws`` (:class:`AugmentDraws`) and ``dropout_keep``
        ({"obj": (S, O, 256), "rel": (S, E, 256)} bool) replace the draws
        from ``generator``; both cover the batch padded to a multiple of dp
        scenes."""
        mesh = self.mesh
        host = batch.numpy()
        padded = host.pad_scenes(mesh.dp)
        S, O = padded.obj_points.shape[:2]
        E = padded.rel_points.shape[1]
        draws = None
        if self.cfg.dataset.data_augmentation:
            draws = augment_draws or draw_augment(S, O, E, generator)
        keep = dict(dropout_keep or {})
        for k, n, head in (("obj", O, self.model.obj_predictor), ("rel", E, self.model.rel_predictor)):
            if k not in keep:
                keep[k] = draw_keep((S, n, head.fc2.weight.shape[0]), generator, "cpu")
        per = S // mesh.dp
        lo, hi = mesh.dp_rank * per, (mesh.dp_rank + 1) * per
        pack = self._pack_for(padded)
        b = dp_block(padded, mesh).to(self.device)
        if draws is not None:
            b = augment_batch_with(b, draws.scenes(slice(lo, hi)).to(self.device))
        keep = {k: v[lo:hi].to(self.device) for k, v in keep.items()}
        out = self.model(b, pack, train=True, dropout_keep=keep)
        loss, parts = sgpn_loss(out, b, self.w_obj, self.w_rel, self.cfg.model.lambda_o, group=mesh.dp_group)
        self.optimizer.zero_grad(set_to_none=True)
        (loss / mesh.mp if mesh.mp > 1 else loss).backward()
        params = self.optimizer.param_groups[0]["params"]
        for p in params:
            if p.grad is None:  # optax updates (decays) every trainable parameter
                p.grad = torch.zeros_like(p)
        if mesh.world is not None:  # each rank's loss has global denominators: the sum is the gradient
            flat = all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]), mesh.world)
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        self.optimizer.step()
        self.step += 1
        self.last_rel_logprobs = self._gather_scenes(out.rel_logprobs.detach(), host.num_scenes)
        names = list(parts)
        total = all_reduce_(torch.stack([parts[k].detach() for k in names]), mesh.dp_group)
        return dict(zip(names, total.unbind(0)))

    @torch.no_grad()
    def eval_step(self, batch: SceneBatch):
        """(rel_logprobs (S, E, R), obj_logprobs (S, O, C)) of the global
        batch on the device; pair-shared batches encode each unordered
        relation pair once."""
        host = batch.numpy()
        padded = host.pad_scenes(self.mesh.dp)
        pack = self._pack_for(padded, paired=is_pair_shared(padded))
        out = self.model(dp_block(padded, self.mesh).to(self.device), pack)
        S = host.num_scenes
        return self._gather_scenes(out.rel_logprobs, S), self._gather_scenes(out.obj_logprobs, S)

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
        """{scan_id: [(subject, relation, object), ...]} over every batch
        (the emission of ``infer.predict_relations`` on :meth:`eval_step`'s
        outputs)."""
        from or4d_tpu_torch.infer import relations_of

        scan_relations: dict[str, list] = {}
        for batch in batches:
            host = batch.numpy()
            scan_relations.update(relations_of(host, self.eval_step(host)[0], self.vocab,
                                               self.model.multi_rel_outputs))
        return scan_relations

    def fit(self, train_batches, val_batches=None, epochs: int | None = None,
            generator: torch.Generator | None = None, log_every: int = 100, checkpoint_dir: str | None = None,
            serving_val: bool = False, log_dir: str | None = None):
        """Epoch loop with per-take metric accumulation (reference
        training_epoch_end/validation_epoch_end); a checkpoint per epoch
        when ``checkpoint_dir``. Returns the per-epoch history. Steps are
        timed by a :class:`~or4d_tpu_torch.utils.profiling.StepTimer`
        (its summary in the step line). Only rank 0 prints, logs and writes
        checkpoints.

        ``log_dir``: a :class:`~or4d_tpu_torch.utils.logging.MetricsLogger`
        named after the config writes, per epoch, the record and
        ``steps_per_sec`` (the mean over the last 50 steps), the per-take
        train P/R/F1 and the train classification report, as the JAX
        package's ``fit`` does.

        ``serving_val``: the per-epoch validation goes through one
        :class:`~or4d_tpu_torch.serving.ServingEvaluator` built before the
        loop, so the val split's weight-independent SA1 geometry is computed
        once instead of every epoch."""
        from or4d_tpu_torch.train import checkpoint as ckpt

        lead = self.mesh.rank == 0
        logger = None
        if log_dir and lead:
            from or4d_tpu_torch.utils.logging import MetricsLogger

            logger = MetricsLogger(log_dir, name=self.cfg.name)
        timer = StepTimer()
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
                with timer.step():
                    parts = self.train_step(batch, generator)
                    losses.append(float(parts["loss"]))
                acc.update_batch(batch.numpy(), self.last_rel_logprobs)
                if lead and log_every and i % log_every == 0:
                    print(f"epoch {epoch} step {i}: loss={losses[-1]:.4f} ({timer.summary()})")
            record = {"epoch": epoch, "train_loss": float(np.mean(losses)), "train_macro_f1": acc.macro_f1,
                      "seconds": time.perf_counter() - t0}
            if val_batches is not None:
                record["val_macro_f1"] = server.evaluate() if server is not None else self.evaluate(val_batches)
            history.append(record)
            if lead:
                print(f"epoch {epoch}: {record}")
            if logger:
                logged = {k: v for k, v in record.items() if k != "seconds"}
                logger.log(epoch, **logged, steps_per_sec=1e3 / timer.mean_ms if timer.mean_ms else 0.0)
                logger.log_per_take(epoch, "train", acc.per_take_reports())
                logger.log_report("train_report", epoch, acc.overall_report().to_text())
            if checkpoint_dir and lead:
                ckpt.save(checkpoint_dir, self.model, self.optimizer, self.step)
        if logger:
            logger.close()
        return history
