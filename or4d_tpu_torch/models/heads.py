"""Classifier heads (port of ``or4d_tpu/models/heads.py``).

Reference ``network_PointNet.py``: PointNetCls (:188-224) 256 -> 512 ->
relu -> 256 -> dropout(0.3) -> relu -> num_classes -> log_softmax;
PointNetRelCls (:227-271) the same trunk with the 768-d image embedding
(the multimodal model) and the 12-d subject/object type one-hots
late-fused before the last layer, in that order; PointNetRelClsMulti
(:274-318, ``multi_label``) returns sigmoid probabilities instead of
log-probabilities (MULTI_REL_OUTPUTS). Dropout is the identity in eval;
in train it keeps a unit with probability 0.7 and scales it by 1/0.7 (flax
``nn.Dropout``). The keep-mask is drawn by :func:`draw_keep` from a
``torch.Generator``, or handed in, so two runs can share it.
Xavier-normal init, as the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from or4d_tpu_torch.models.layers import Dense


DROPOUT = 0.3


def _xavier(i, o, device, generator):
    return Dense(i, o, device=device, generator=generator, init="xavier")


def draw_keep(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """A dropout keep-mask (bool, True with probability 0.7), drawn on the
    CPU so a run on the card and one on the CPU draw the same bits."""
    return (torch.rand(shape, generator=generator) < 1.0 - DROPOUT).to(device)


def _trunk(head, x, train: bool, keep):
    x = head.fc2(torch.relu(head.fc1(x)))
    if train:
        x = torch.where(keep, x / (1.0 - DROPOUT), torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.relu(x)


class ObjectClsHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int, device=None, generator=None):
        super().__init__()
        self.fc1 = _xavier(in_features, 512, device, generator)
        self.fc2 = _xavier(512, 256, device, generator)
        self.fc3 = _xavier(256, num_classes, device, generator)

    def forward(self, x, train: bool = False, keep: torch.Tensor | None = None):
        """``keep``: the train-mode dropout mask, shaped like fc2's output."""
        return torch.log_softmax(self.fc3(_trunk(self, x, train, keep)), dim=-1)


class RelationClsHead(nn.Module):
    def __init__(self, in_features: int, num_relations: int, onehot_features: int = 12, image_features: int = 0,
                 multi_label: bool = False, device=None, generator=None):
        super().__init__()
        self.multi_label = multi_label
        self.fc1 = _xavier(in_features, 512, device, generator)
        self.fc2 = _xavier(512, 256, device, generator)
        self.fc3 = _xavier(256 + image_features + onehot_features, num_relations, device, generator)

    def forward(self, x, relation_objects_one_hot, train: bool = False, keep: torch.Tensor | None = None,
                image_embeddings: torch.Tensor | None = None):
        """``image_embeddings``: (S, D) one vector a scene, fused after the
        trunk's 256 features and before the one-hots."""
        x = _trunk(self, x, train, keep)
        parts = [x]
        if image_embeddings is not None:
            parts.append(image_embeddings[..., None, :].to(x.dtype).expand(*x.shape[:-1], -1))
        parts.append(relation_objects_one_hot.to(x.dtype))
        x = self.fc3(torch.cat(parts, dim=-1))
        return torch.sigmoid(x) if self.multi_label else torch.log_softmax(x, dim=-1)
