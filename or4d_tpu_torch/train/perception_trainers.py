"""Trainers for the L1 perception models (port of
``or4d_tpu/train/perception_trainers.py``): the Group-Free detector.

Reference training envelope (SURVEY.md §2.4/§6): Group-Free, AdamW,
stepwise LR decay, 180 epochs batch 16 (train_dist.py:56-117).

The HigherHRNet and VoxelPose trainers of the JAX module come with their
models (ROADMAP Queue 1 item 5b).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from or4d_tpu_torch.device import resolve_device


def piecewise_constant_lr(lr: float, boundaries: tuple, rate: float):
    """optax ``piecewise_constant_schedule(lr, {b: rate for b in
    boundaries})`` of the 0-indexed update count, in float32: the rate is
    applied once for every boundary at or below the count."""
    f32 = np.float32

    def schedule(step: int) -> float:
        v = f32(lr)
        for b in boundaries:
            if step >= b:
                v = f32(v * f32(rate))
        return float(v)

    return schedule


@dataclasses.dataclass
class GroupFreeTrainer:
    """3D detection: KPS + per-head box/sem losses, AdamW + step decay.

    ``torch.optim.AdamW`` with betas 0.9/0.999, eps 1e-8 and the decay on
    every parameter (optax ``adamw``'s defaults, as the JAX trainer uses
    them); the LR is set before each update from the update count. The
    model runs on ``device`` (``cuda`` unless ``device="cpu"``; raises
    without a card). The decoder's attention dropout draws from the
    ``generator`` a step is given, else from the trainer's own, seeded with
    ``seed`` on its device."""

    num_proposal: int = 128
    num_decoder_layers: int = 6
    lr: float = 6e-3
    weight_decay: float = 5e-4
    decay_steps: tuple = (56000, 78000, 90000)
    decay_rate: float = 0.1
    dropout: float = 0.1
    device: str | torch.device | None = None
    seed: int = 0

    def __post_init__(self):
        from or4d_tpu_torch.models.groupfree import GroupFreeDetector

        self.device = resolve_device(self.device)
        self.model = GroupFreeDetector(num_proposal=self.num_proposal, num_decoder_layers=self.num_decoder_layers,
                                       dropout=self.dropout, device=self.device, seed=self.seed)
        self.schedule = piecewise_constant_lr(self.lr, tuple(self.decay_steps), self.decay_rate)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=self.schedule(0), betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=self.weight_decay)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.step = 0  # updates applied

    def loss(self, pc, mean_size_arr, point_instance_label, gt: dict, generator=None):
        """(total, parts) of one train-mode forward (BN running statistics
        updated)."""
        from or4d_tpu_torch.models.groupfree_loss import groupfree_total_loss

        out = self.model(pc, mean_size_arr, train=True, generator=generator or self.generator)
        # per-seed instance assignment via the backbone's own seed indices
        # (reference loss_helper.py:11-21 gather)
        seed_instance = torch.gather(point_instance_label.long(), 1, out["seed_inds"].long())
        return groupfree_total_loss(out, seed_instance, gt, mean_size_arr, out["seed_xyz"])

    def train_step(self, pc, mean_size_arr, point_instance_label, gt: dict, generator: torch.Generator | None = None):
        """One update on one batch; returns (loss, parts), detached."""
        from or4d_tpu_torch.models.groupfree import mean_sizes

        dev = self.device
        pc = torch.as_tensor(pc, dtype=torch.float32, device=dev)
        msa = mean_sizes(mean_size_arr, dev)
        label = torch.as_tensor(point_instance_label, device=dev)
        gt = {k: torch.as_tensor(v, device=dev) for k, v in gt.items()}
        gt = {k: v.float() if v.is_floating_point() else v for k, v in gt.items()}
        total, parts = self.loss(pc, msa, label, gt, generator)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        self._update()
        return total.detach(), _detach(parts)

    def _update(self) -> None:
        """One AdamW update from the parameters' ``.grad`` at the schedule's
        rate for this update count."""
        for p in self.model.parameters():
            if p.grad is None:  # optax updates (decays) every parameter
                p.grad = torch.zeros_like(p)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1

    def train_step_from_batch(self, batch: dict, mean_size_arr, generator: torch.Generator | None = None):
        """One step from a ``GroupFreeDetectionDataset.batch()`` dict."""
        return self.train_step(batch["point_clouds"], mean_size_arr, batch["point_instance_label"], batch["gt"],
                               generator)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()
