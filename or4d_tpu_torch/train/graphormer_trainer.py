"""Graphormer role-prediction trainer (port of
``or4d_tpu/train/graphormer_trainer.py``).

Reference: `role_prediction/graphormer/entry.py` + `model.py` training logic:
  * AdamW, peak_lr 2e-4, weight_decay (model.py:403-407): ``torch.optim.AdamW``
    with betas 0.9/0.999, eps 1e-8 and decay on every parameter, optax's
    ``adamw`` defaults as the JAX package uses them;
  * PolynomialDecayLR: linear warmup 40000 updates then power-1 decay to
    end_lr over 400000 (lr.py:7-34), set on the optimizer before each update
    from the update count;
  * CE loss over 5 roles, one label per track;
  * WeightedRandomSampler balancing roles (data.py:83-116);
  * FLAG adversarial training of the node embeddings (utils/flag.py:9-51);
  * eval: temperature-4 softmax scores per track
    (role_prediction_helpers.py:161).

The trainer runs on ``device`` (``cuda`` unless ``device="cpu"``; raises
without a card). Dropout masks and FLAG's first perturbation come from the
``generator`` a step is given, else from the trainer's own, seeded with
``seed`` on its device; a CPU generator gives a card step the CPU's draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.models.graphormer import ROLE_NAMES, Graphormer, GraphormerBatch


def polynomial_decay_lr(peak_lr: float, end_lr: float, warmup: int, total: int, power: float = 1.0):
    """The reference PolynomialDecayLR as a function of the 0-indexed
    update count (optax's count; torch's ``_step_count`` is that plus 1),
    in float32 as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step) + f32(1.0)
        if s <= warmup:
            return float(s / f32(max(warmup, 1)) * f32(peak_lr))
        if s >= total:
            return float(f32(end_lr))
        pct = f32(1.0) - (s - f32(warmup)) / f32(max(total - warmup, 1))
        return float(f32(peak_lr - end_lr) * np.clip(pct, f32(0.0), f32(1.0)) ** f32(power) + f32(end_lr))

    return schedule


@dataclasses.dataclass
class GraphormerTrainer:
    n_layers: int = 12
    hidden: int = 80
    ffn: int = 80
    heads: int = 8
    dropout: float = 0.1
    peak_lr: float = 2e-4
    end_lr: float = 1e-9
    weight_decay: float = 0.01
    warmup_updates: int = 40_000
    tot_updates: int = 400_000
    num_classes: int = 5
    device: str | torch.device | None = None
    seed: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = Graphormer(num_classes=self.num_classes, n_layers=self.n_layers, hidden=self.hidden,
                                ffn=self.ffn, heads=self.heads, dropout=self.dropout, attn_dropout=self.dropout,
                                input_dropout=self.dropout, device=self.device, seed=self.seed)
        self.schedule = polynomial_decay_lr(self.peak_lr, self.end_lr, self.warmup_updates, self.tot_updates)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=self.schedule(0), betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=self.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.step = 0  # updates applied

    def _loss(self, batch: GraphormerBatch, label: int, generator, perturb=None) -> torch.Tensor:
        logits = self.model(batch, train=True, perturb=perturb, generator=generator or self.generator)
        return -torch.log_softmax(logits, dim=-1)[label]

    def _update(self) -> None:
        """One AdamW update at the schedule's rate for this update count."""
        for p in self.model.parameters():
            if p.grad is None:  # optax updates (decays) every parameter
                p.grad = torch.zeros_like(p)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1

    def train_step(self, batch: GraphormerBatch, label: int, generator: torch.Generator | None = None):
        """One update on one track; returns the loss (a detached 0-d tensor)."""
        loss = self._loss(batch.to(self.device), label, generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._update()
        return loss.detach()

    def flag_train_step(self, batch: GraphormerBatch, label: int, generator: torch.Generator | None = None,
                        m: int = 3, step_size: float = 1e-3, mag: float = 1e-3, perturb: torch.Tensor | None = None):
        """FLAG adversarial-perturbation training
        (role_prediction/graphormer/utils/flag.py:9-51): ascend the loss in
        the node-embedding perturbation with sign steps projected to an L2
        ball of radius ``mag``, averaging the loss and the parameter
        gradients over m inner steps. ``perturb`` (G, N, hidden) replaces
        the first perturbation's draw, uniform in +-mag/sqrt(hidden).
        Returns the mean loss (a detached 0-d tensor)."""
        batch = batch.to(self.device)
        gen = generator or self.generator
        G, N = batch.x.shape
        if perturb is None:
            u = torch.rand((G, N, self.hidden), generator=gen, device=gen.device)
            perturb = (u * 2.0 - 1.0) * (mag / math.sqrt(self.hidden))
        perturb = perturb.to(self.device)
        params = list(self.model.parameters())
        acc = [torch.zeros_like(p) for p in params]
        total = torch.zeros((), device=self.device)
        for _ in range(m):
            pert = perturb.detach().requires_grad_(True)
            loss = self._loss(batch, label, gen, pert)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            with torch.no_grad():
                for a, p in zip(acc, params):
                    if p.grad is not None:
                        a.add_(p.grad / m)
                total += loss / m
                perturb = pert + step_size * torch.sign(pert.grad)
                norm = torch.linalg.vector_norm(perturb, dim=-1, keepdim=True)
                perturb = torch.where(norm > mag, perturb * (mag / torch.clamp(norm, min=1e-12)), perturb)
        for a, p in zip(acc, params):
            p.grad = a
        self._update()
        return total

    @torch.no_grad()
    def score_track(self, batch: GraphormerBatch) -> dict[str, float]:
        """The temperature-4 softmax scores of one track by role name."""
        scores = torch.softmax(self.model(batch.to(self.device), train=False) / 4.0, dim=-1).cpu().numpy()
        return {name: float(scores[i]) for i, name in enumerate(ROLE_NAMES)}

    def fit(self, tracks: list[tuple[GraphormerBatch, int]], epochs: int = 1, balance: bool = True,
            checkpoint_dir=None, generator: torch.Generator | None = None) -> list[float]:
        """``tracks``: (batch, role_label) pairs; weighted sampling balances
        role frequencies (reference WeightedRandomSampler), in the JAX
        package's order (``np.random.default_rng(0)``). With
        ``checkpoint_dir`` the model and optimizer are saved after every
        epoch (step = the epoch), the reference's ModelCheckpoint(save_last)
        + last.ckpt auto-resume (entry.py:95-107). Returns the losses."""
        from or4d_tpu_torch.train import checkpoint as ckpt

        labels = np.array([t[1] for t in tracks])
        p = None
        if balance and len(tracks) > 1:
            counts = np.bincount(labels, minlength=self.num_classes).astype(np.float64)
            w = 1.0 / np.maximum(counts[labels], 1.0)
            p = w / w.sum()
        nrng = np.random.default_rng(0)
        losses = []
        for epoch in range(epochs):
            order = nrng.choice(len(tracks), size=len(tracks), replace=balance, p=p)
            for i in order:
                batch, label = tracks[int(i)]
                losses.append(self.train_step(batch, label, generator))
            if checkpoint_dir is not None:
                ckpt.save(checkpoint_dir, self.model, self.optimizer, step=epoch)
        return [float(loss) for loss in losses]

    def restore(self, checkpoint_dir) -> int:
        """Load the latest checkpoint of ``checkpoint_dir`` (model and
        optimizer, the update count from the optimizer's state); returns
        its step (the epoch it was saved after)."""
        from or4d_tpu_torch.train import checkpoint as ckpt

        step = ckpt.restore(checkpoint_dir, self.model, self.optimizer)
        counts = [int(s["step"]) for s in self.optimizer.state.values() if "step" in s]
        self.step = max(counts, default=0)
        return step
