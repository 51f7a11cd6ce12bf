"""Classifier heads (port of ``or4d_tpu/models/heads.py``, eval semantics).

Reference ``network_PointNet.py``: PointNetCls (:188-224) 256 -> 512 ->
relu -> 256 -> dropout -> relu -> num_classes -> log_softmax;
PointNetRelCls (:227-271) the same trunk with the 12-d subject/object type
one-hots late-fused before the last layer. Dropout is the identity in eval.
Xavier-normal init, as the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from or4d_tpu_torch.models.layers import Dense


def _xavier(i, o, device, generator):
    return Dense(i, o, device=device, generator=generator, init="xavier")


class ObjectClsHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int, device=None, generator=None):
        super().__init__()
        self.fc1 = _xavier(in_features, 512, device, generator)
        self.fc2 = _xavier(512, 256, device, generator)
        self.fc3 = _xavier(256, num_classes, device, generator)

    def forward(self, x):
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return torch.log_softmax(self.fc3(x), dim=-1)


class RelationClsHead(nn.Module):
    def __init__(self, in_features: int, num_relations: int, onehot_features: int = 12, device=None, generator=None):
        super().__init__()
        self.fc1 = _xavier(in_features, 512, device, generator)
        self.fc2 = _xavier(512, 256, device, generator)
        self.fc3 = _xavier(256 + onehot_features, num_relations, device, generator)

    def forward(self, x, relation_objects_one_hot):
        x = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        x = torch.cat([x, relation_objects_one_hot.to(x.dtype)], dim=-1)
        return torch.log_softmax(self.fc3(x), dim=-1)
