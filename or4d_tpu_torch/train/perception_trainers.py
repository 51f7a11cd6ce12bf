"""Trainers for the L1 perception models (port of
``or4d_tpu/train/perception_trainers.py``).

Reference training envelopes (SURVEY.md §2.4/§6):
  * HigherHRNet: heatmap MSE + AE pull/push, Adam (tools/dist_train.py);
  * VoxelPose: patient-weighted L1 pose loss, Adam 1e-4
    (run/train_3d.py, multi_person_posenet.py:36-103);
  * Group-Free: AdamW, stepwise LR decay, 180 epochs batch 16
    (train_dist.py:56-117).

Adam and AdamW are ``torch.optim``'s with optax's defaults (betas 0.9 /
0.999, eps 1e-8); every parameter takes part in every update, as an optax
update of the whole tree does (a parameter without a gradient gets a zero
one).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.models.layers import no_tf32


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


def _all_grads(model: torch.nn.Module) -> None:
    for p in model.parameters():
        if p.grad is None:  # optax updates every parameter
            p.grad = torch.zeros_like(p)


@dataclasses.dataclass
class HigherHRNetTrainer:
    """2D pose: dual-resolution heatmap MSE + AE loss on the tag maps, Adam
    at ``lr``. The model runs on ``device`` (``cuda`` unless
    ``device="cpu"``; raises without a card), initialised from ``seed``."""

    num_joints: int = 14
    lr: float = 1e-3
    ae_weight: float = 1e-3
    device: str | torch.device | None = None
    seed: int = 0

    def __post_init__(self):
        from or4d_tpu_torch.models.higherhrnet import HigherHRNet

        self.device = resolve_device(self.device)
        self.model = HigherHRNet(num_joints=self.num_joints, device=self.device, seed=self.seed)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.step = 0  # updates applied

    def loss(self, images, gt_low, gt_high, joint_pos, joint_valid) -> torch.Tensor:
        """The JAX trainer's loss of one train-mode forward (BN running
        statistics updated): both scales' heatmap MSE plus ``ae_weight``
        times the per-image AE loss averaged over the batch."""
        from or4d_tpu_torch.models.higherhrnet import ae_loss, heatmap_loss

        low, high = self.model(images, train=True)
        J = self.num_joints
        l_hm = heatmap_loss(low[..., :J], gt_low) + heatmap_loss(high, gt_high)
        l_ae = 0.0
        for b in range(images.shape[0]):
            # tag positions live at 1/4 resolution
            l_ae = l_ae + ae_loss(low[b, ..., J:], joint_pos[b], joint_valid[b])[0]
        return l_hm + self.ae_weight * l_ae / images.shape[0]

    def train_step(self, images, gt_low, gt_high, joint_pos, joint_valid) -> torch.Tensor:
        """One Adam update on one batch (numpy or tensors); returns the
        loss, detached, on the device."""
        dev = self.device
        f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        total = self.loss(f(images), f(gt_low), f(gt_high), torch.as_tensor(joint_pos, device=dev),
                          torch.as_tensor(joint_valid, device=dev))
        self.optimizer.zero_grad(set_to_none=True)
        with no_tf32():  # the backward's convolutions too
            total.backward()
        _all_grads(self.model)
        self.optimizer.step()
        self.step += 1
        return total.detach()

    def train_step_from_batch(self, batch: dict) -> torch.Tensor:
        """One step from a ``HigherHRNetDataset.batches()`` dict."""
        return self.train_step(batch["images"], batch["gt_low"], batch["gt_high"], batch["joint_pos"],
                               batch["joint_valid"])


def cameras_on(cameras: dict, device) -> dict:
    """A ``cam_infos_to_voxelpose`` dict as float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in cameras.items()}


@dataclasses.dataclass
class VoxelPoseTrainer:
    """3D pose: patient-weighted L1 on matched poses (LOSS.PATIENT_WEIGHT 4)
    and the root cube's MSE, Adam at ``lr``, one optimizer for both
    updates of an iteration (the reference's core/function.py:36-69 for the
    OR_4D input-heatmap path, where loss_2d == 0):

      1. if loss_cord > 0: an update from the pose (cord) loss's gradient;
      2. every ``accumulation_steps``-th iteration with a positive
         accumulated loss_3d: a second update from the accumulated root-cube
         gradients, and that iteration's own loss_3d is dropped (the
         reference's if/else, :63-69); otherwise loss_3d's gradient / steps
         is accumulated.

    The two gradients touch disjoint parameters — the centres reach the
    pose net through top-k indices, so loss_cord reaches only ``pose_v2v``
    and loss_3d only ``proposal_v2v`` — so one backward of their sum gives
    both, split by parameter set. ``model_kwargs`` override the VoxelPose
    geometry. The model runs on ``device`` (``cuda`` unless
    ``device="cpu"``; raises without a card)."""

    lr: float = 1e-4
    patient_weight: float = 4.0
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    accumulation_steps: int = 4
    device: str | torch.device | None = None
    seed: int = 0

    def __post_init__(self):
        from or4d_tpu_torch.models.voxelpose import VoxelPose

        self.device = resolve_device(self.device)
        self.model = VoxelPose(**self.model_kwargs, device=self.device, seed=self.seed)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.proposal_params = [p for _, p in self.model.proposal_v2v.named_parameters()]
        self.accum3d = [torch.zeros_like(p) for p in self.proposal_params]
        self.accum3d_loss = torch.zeros((), device=self.device)
        self.step = 0  # iterations (the JAX state's "step")

    def losses(self, heatmaps, cameras, heatmap_scale, gt_roots, gt_poses, gt_vis, gt_mask, patient_slots,
               target_3d):
        """(loss_cord, loss_3d) of one train-mode forward (BN running
        statistics updated)."""
        from or4d_tpu_torch.models.voxelpose import voxelpose_loss, voxelpose_loss_3d

        poses, _scores, centers, root = self.model(heatmaps, cameras, heatmap_scale, train=True)
        loss_cord = voxelpose_loss(poses, centers, gt_roots, gt_poses, gt_vis, gt_mask,
                                   patient_slot_mask=patient_slots, patient_weight=self.patient_weight)
        return loss_cord, voxelpose_loss_3d(root, target_3d)

    def _update(self, grads: dict) -> None:
        """One Adam update of every parameter: ``grads`` {param: gradient},
        zero for the others."""
        for p in self.model.parameters():
            p.grad = grads.get(p, torch.zeros_like(p))
        self.optimizer.step()

    def train_step(self, heatmaps, cameras, heatmap_scale, gt_roots, gt_poses, gt_vis, gt_mask, patient_slots,
                   target_3d):
        """One iteration on one frame (tensors on the device); returns
        (loss_cord + loss_3d, {"loss_cord", "loss_3d"}), detached."""
        loss_cord, loss_3d = self.losses(heatmaps, cameras, heatmap_scale, gt_roots, gt_poses, gt_vis, gt_mask,
                                         patient_slots, target_3d)
        self.optimizer.zero_grad(set_to_none=True)
        with no_tf32():  # the backward's convolutions too
            (loss_cord + loss_3d).backward()
        _all_grads(self.model)
        self.update(float(loss_cord), loss_3d.detach(), {p: p.grad for p in self.model.parameters()})
        return (loss_cord + loss_3d).detach(), {"loss_cord": loss_cord.detach(), "loss_3d": loss_3d.detach()}

    def update(self, loss_cord: float, loss_3d: torch.Tensor, grads: dict) -> None:
        """The iteration's updates from its losses and gradients ({param:
        gradient}; the proposal net's are loss_3d's, the rest loss_cord's)."""
        proposal = set(self.proposal_params)
        if loss_cord > 0:
            self._update({p: g for p, g in grads.items() if p not in proposal})
        nacc = float(self.accumulation_steps)
        if float(self.accum3d_loss) > 0 and (self.step + 1) % self.accumulation_steps == 0:
            self._update(dict(zip(self.proposal_params, self.accum3d)))
            self.accum3d = [torch.zeros_like(a) for a in self.accum3d]
            self.accum3d_loss = torch.zeros_like(self.accum3d_loss)
        else:
            self.accum3d = [a + grads[p] / nacc for a, p in zip(self.accum3d, self.proposal_params)]
            self.accum3d_loss = self.accum3d_loss + loss_3d / nacc
        self.step += 1

    def train_step_from_sample(self, sample: dict, cameras: dict, heatmap_scale):
        """One ``VoxelPoseDataset`` frame dict -> a train step; ``cameras``
        from :func:`cameras_on`."""
        dev = self.device
        t = lambda k: torch.as_tensor(sample[k], device=dev)
        return self.train_step(t("input_heatmaps"), cameras, torch.as_tensor(heatmap_scale, device=dev),
                               t("gt_roots"), t("gt_poses"), t("gt_vis"), t("gt_mask"), t("patient_mask"),
                               t("target_3d"))


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()
