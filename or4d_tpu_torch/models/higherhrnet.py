"""HigherHRNet — bottom-up 2D multi-person pose estimation (port of
``or4d_tpu/models/higherhrnet.py``).

Reference: `external_src/HigherHRNet/` (HRNet-W32 trunk,
`higherhrnet_lib/models/pose_higher_hrnet.py`; 14 joints for 4D-OR; heatmap
grouping/aggregation in `core/group.py`, `core/inference.py`).

Architecture:
  * stem: two stride-2 3x3 convs to 64ch;
  * 4 stages of parallel multi-resolution branches (widths 32/64/128/256),
    each stage = residual basic blocks per branch + full multi-scale fusion
    (strided-conv down, 1x1 + nearest upsample up);
  * head 1 (1/4 resolution): 1x1 conv -> num_joints heatmaps + num_joints
    associative-embedding tags;
  * head 2 (1/2 resolution): deconv block on [features | head-1 output] ->
    basic blocks -> num_joints heatmaps.

The convolutions are ``F.conv2d`` / ``F.conv_transpose2d`` (cuDNN on the
card, TF32 off: the JAX reference is float32), channels-first inside; the
model takes and returns channels-last tensors as the JAX module does. A
strided "SAME" convolution pads the odd pixel after (:func:`same_pad`). The
deconvolution's weight is stored as ``F.conv_transpose2d`` takes it: flax's
``ConvTranspose`` kernel flipped in both spatial axes
(:mod:`or4d_tpu_torch.convert`). BN is flax's: biased batch variance,
running statistics ``0.99 * running + 0.01 * batch``
(:class:`~or4d_tpu_torch.models.layers.FlaxBatchNorm`). Parameter names
follow the flax tree.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.models.layers import FlaxBatchNorm, ConvNd, no_tf32

NUM_JOINTS = 14
WIDTHS = (32, 64, 128, 256)


def _conv(cin, cout, k, stride=1, bias=False, **kw) -> ConvNd:
    return ConvNd(2, cin, cout, k, stride, bias, **kw)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, **kw):
        super().__init__()
        bn = dict(device=kw["device"])
        self.conv1, self.bn1 = _conv(cin, features, 3, **kw), FlaxBatchNorm(features, **bn)
        self.conv2, self.bn2 = _conv(features, features, 3, **kw), FlaxBatchNorm(features, **bn)
        self.down = cin != features
        if self.down:
            self.down_conv, self.down_bn = _conv(cin, features, 1, **kw), FlaxBatchNorm(features, **bn)

    def forward(self, x, train: bool = True):
        r = F.relu(self.bn1(self.conv1(x), train))
        r = self.bn2(self.conv2(r), train)
        if self.down:
            x = self.down_bn(self.down_conv(x), train)
        return F.relu(r + x)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, **kw):  # output = features * 4
        super().__init__()
        out = features * 4
        bn = dict(device=kw["device"])
        self.conv1, self.bn1 = _conv(cin, features, 1, **kw), FlaxBatchNorm(features, **bn)
        self.conv2, self.bn2 = _conv(features, features, 3, **kw), FlaxBatchNorm(features, **bn)
        self.conv3, self.bn3 = _conv(features, out, 1, **kw), FlaxBatchNorm(out, **bn)
        self.down = cin != out
        if self.down:
            self.down_conv, self.down_bn = _conv(cin, out, 1, **kw), FlaxBatchNorm(out, **bn)

    def forward(self, x, train: bool = True):
        r = F.relu(self.bn1(self.conv1(x), train))
        r = F.relu(self.bn2(self.conv2(r), train))
        r = self.bn3(self.conv3(r), train)
        if self.down:
            x = self.down_bn(self.down_conv(x), train)
        return F.relu(r + x)


class FuseLayer(nn.Module):
    """Full multi-scale fusion across branches (HRNet exchange unit)."""

    def __init__(self, widths: tuple[int, ...], **kw):
        super().__init__()
        self.n = n = len(widths)
        bn = dict(device=kw["device"])
        for i in range(n):
            for j in range(n):
                if j > i:  # upsample lower-res branch
                    self.add_module(f"up_{i}_{j}_conv", _conv(widths[j], widths[i], 1, **kw))
                    self.add_module(f"up_{i}_{j}_bn", FlaxBatchNorm(widths[i], **bn))
                for k in range(i - j):  # downsample higher-res branch with strided convs
                    w = widths[i] if k == i - j - 1 else widths[j]
                    self.add_module(f"dn_{i}_{j}_{k}_conv", _conv(widths[j], w, 3, 2, **kw))
                    self.add_module(f"dn_{i}_{j}_{k}_bn", FlaxBatchNorm(w, **bn))

    def forward(self, xs, train: bool = True):
        outs = []
        for i in range(self.n):
            acc = None
            for j in range(self.n):
                y = xs[j]
                if j > i:
                    y = getattr(self, f"up_{i}_{j}_bn")(getattr(self, f"up_{i}_{j}_conv")(y), train)
                    y = F.interpolate(y, scale_factor=2 ** (j - i), mode="nearest")
                for k in range(i - j):
                    y = getattr(self, f"dn_{i}_{j}_{k}_bn")(getattr(self, f"dn_{i}_{j}_{k}_conv")(y), train)
                    if k < i - j - 1:
                        y = F.relu(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class Stage(nn.Module):
    def __init__(self, widths: tuple[int, ...], branches: int, blocks: int = 4, **kw):
        super().__init__()
        self.branches, self.blocks = branches, blocks
        for bi in range(branches):
            for l in range(blocks):
                self.add_module(f"branch{bi}_block{l}", BasicBlock(widths[bi], widths[bi], **kw))
        self.fuse = FuseLayer(widths[:branches], **kw)

    def forward(self, xs, train: bool = True):
        ys = []
        for bi, x in enumerate(xs):
            for l in range(self.blocks):
                x = getattr(self, f"branch{bi}_block{l}")(x, train)
            ys.append(x)
        return self.fuse(ys, train)


class HigherHRNet(nn.Module):
    """images (B, H, W, 3) -> (low (B, H/4, W/4, 2J): heatmaps then tags,
    high (B, H/2, W/2, J)), channels-last. Built on ``device`` (the card
    unless given "cpu"; raises without one) from a CPU generator seeded with
    ``seed``."""

    def __init__(self, num_joints: int = NUM_JOINTS, with_tags: bool = True, device=None,
                 generator: torch.Generator | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        kw = dict(device=device, generator=generator)
        bn = dict(device=device)
        self.num_joints = num_joints
        self.stem1, self.stem1_bn = _conv(3, 64, 3, 2, **kw), FlaxBatchNorm(64, **bn)
        self.stem2, self.stem2_bn = _conv(64, 64, 3, 2, **kw), FlaxBatchNorm(64, **bn)
        for l in range(4):
            self.add_module(f"layer1_{l}", Bottleneck(64 if l == 0 else 256, 64, **kw))
        self.t1_conv0, self.t1_bn0 = _conv(256, WIDTHS[0], 3, **kw), FlaxBatchNorm(WIDTHS[0], **bn)
        self.t1_conv1, self.t1_bn1 = _conv(256, WIDTHS[1], 3, 2, **kw), FlaxBatchNorm(WIDTHS[1], **bn)
        self.stage2 = Stage(WIDTHS, 2, **kw)
        self.t2_conv, self.t2_bn = _conv(WIDTHS[1], WIDTHS[2], 3, 2, **kw), FlaxBatchNorm(WIDTHS[2], **bn)
        for rep in range(4):
            self.add_module(f"stage3_{rep}", Stage(WIDTHS, 3, **kw))
        self.t3_conv, self.t3_bn = _conv(WIDTHS[2], WIDTHS[3], 3, 2, **kw), FlaxBatchNorm(WIDTHS[3], **bn)
        for rep in range(3):
            self.add_module(f"stage4_{rep}", Stage(WIDTHS, 4, **kw))
        out_ch = num_joints * (2 if with_tags else 1)
        self.final_low = _conv(WIDTHS[0], out_ch, 1, bias=True, **kw)
        self.deconv = ConvNd(2, WIDTHS[0] + out_ch, WIDTHS[0], 4, 2, False, transpose=True, **kw)
        self.deconv_bn = FlaxBatchNorm(WIDTHS[0], **bn)
        for l in range(4):
            self.add_module(f"refine_{l}", BasicBlock(WIDTHS[0], WIDTHS[0], **kw))
        self.final_high = _conv(WIDTHS[0], num_joints, 1, bias=True, **kw)

    def forward(self, images: torch.Tensor, train: bool = True):
        with no_tf32():
            return self._forward(images, train)

    def _forward(self, images, train):
        x = images.permute(0, 3, 1, 2)
        x = F.relu(self.stem1_bn(self.stem1(x), train))
        x = F.relu(self.stem2_bn(self.stem2(x), train))
        for l in range(4):
            x = getattr(self, f"layer1_{l}")(x, train)
        xs = [F.relu(self.t1_bn0(self.t1_conv0(x), train)), F.relu(self.t1_bn1(self.t1_conv1(x), train))]
        xs = self.stage2(xs, train)
        xs = xs + [F.relu(self.t2_bn(self.t2_conv(xs[-1]), train))]
        for rep in range(4):
            xs = getattr(self, f"stage3_{rep}")(xs, train)
        xs = xs + [F.relu(self.t3_bn(self.t3_conv(xs[-1]), train))]
        for rep in range(3):
            xs = getattr(self, f"stage4_{rep}")(xs, train)
        feat = xs[0]
        low = self.final_low(feat)
        up = F.relu(self.deconv_bn(self.deconv(torch.cat([feat, low], dim=1)), train))
        for l in range(4):
            up = getattr(self, f"refine_{l}")(up, train)
        high = self.final_high(up)
        return low.permute(0, 2, 3, 1), high.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# training losses: heatmap MSE + associative-embedding pull/push
# (reference: HigherHRNet core/loss.py — HeatmapLoss and AELoss)
# ---------------------------------------------------------------------------

def heatmap_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel MSE against gaussian-rendered GT heatmaps; optional valid
    mask (the reference masks crowd regions)."""
    d = (pred - gt) ** 2
    if mask is not None:
        d = d * mask[..., None]
    return d.mean()


def ae_loss(tags: torch.Tensor, joint_pos: torch.Tensor, joint_valid: torch.Tensor, pull_weight: float = 1.0,
            push_weight: float = 1.0):
    """Associative-embedding grouping loss (Newell et al.; core/loss.py
    AELoss). ``tags``: (H, W, J) predicted tag maps; ``joint_pos``: (P, J, 2)
    int GT pixel positions per person; ``joint_valid``: (P, J) bool. Pull:
    each person's joint tags toward their mean; push: person means apart
    (exp(-d^2) penalty). Invalid people/joints masked."""
    P, J, _ = joint_pos.shape
    xs = joint_pos[..., 0].long().clamp(0, tags.shape[1] - 1)
    ys = joint_pos[..., 1].long().clamp(0, tags.shape[0] - 1)
    jidx = torch.arange(J, device=tags.device)[None, :].expand(P, J)
    per_joint_tags = tags[ys, xs, jidx]  # (P, J)
    v = joint_valid.to(tags.dtype)
    counts = torch.clamp(v.sum(dim=1), min=1.0)
    means = (per_joint_tags * v).sum(dim=1) / counts  # (P,)
    pull = (((per_joint_tags - means[:, None]) ** 2) * v).sum() / torch.clamp(v.sum(), min=1.0)
    person_valid = (v.sum(dim=1) > 0).to(tags.dtype)
    diff = means[:, None] - means[None, :]
    pv = person_valid[:, None] * person_valid[None, :] * (1.0 - torch.eye(P, dtype=tags.dtype, device=tags.device))
    push = (torch.exp(-(diff ** 2)) * pv).sum() / torch.clamp(pv.sum(), min=1.0)
    return pull_weight * pull + push_weight * push, {"pull": pull, "push": push}


def render_gt_heatmaps(joint_pos: torch.Tensor, joint_valid: torch.Tensor, shape: tuple[int, int],
                       sigma: float = 2.0) -> torch.Tensor:
    """GT gaussian heatmaps (H, W, J) from (P, J, 2) pixel positions."""
    H, W = shape
    dev = joint_pos.device
    yy = torch.arange(H, device=dev)[:, None, None, None]
    xx = torch.arange(W, device=dev)[None, :, None, None]
    d2 = (xx - joint_pos[None, None, :, :, 0]) ** 2 + (yy - joint_pos[None, None, :, :, 1]) ** 2
    g = torch.exp(-d2.float() / (2 * sigma ** 2)) * joint_valid[None, None].float()
    return g.amax(dim=2)  # max over people -> (H, W, J)


# ---------------------------------------------------------------------------
# heatmap aggregation + associative-embedding grouping (core/group.py)
# ---------------------------------------------------------------------------

def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (H, W, C), "bilinear")`` of a channels-last
    (H, W, C) map, upsampling (half-pixel centres)."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=size, mode="bilinear", align_corners=False)
    return y[0].permute(1, 2, 0)


def aggregate_heatmaps(low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Average the 1/4-res heatmaps (upsampled) with the 1/2-res ones
    (core/inference.py aggregation). Inputs channels-last; returns (H, W, J)."""
    J = high.shape[-1]
    return (resize_bilinear(low[..., :J], tuple(high.shape[:2])) + high) / 2.0


def group_people_by_tags(heatmaps: np.ndarray, tags: np.ndarray, max_people: int = 10,
                         detection_threshold: float = 0.1, tag_threshold: float = 1.0) -> list[np.ndarray]:
    """Greedy associative-embedding grouping (core/group.py semantics), on
    host arrays: per joint, take top-k peaks; assign each peak to the person
    whose mean tag is closest (within tag_threshold), else start a new
    person. Returns a list of (J, 3) arrays [x, y, score] (0 score =
    missing)."""
    H, W, J = heatmaps.shape
    people: list[dict] = []
    for j in range(J):
        flat = heatmaps[:, :, j].reshape(-1)
        top = np.argsort(-flat)[:max_people]
        for idx in top:
            score = flat[idx]
            if score < detection_threshold:
                break
            y, x = divmod(int(idx), W)
            tag = tags[min(y, tags.shape[0] - 1), min(x, tags.shape[1] - 1), j]
            best, best_d = None, tag_threshold
            for p in people:
                if p["joints"][j, 2] > 0:
                    continue  # one peak per joint per person
                d = abs(p["tag_sum"] / p["count"] - tag)
                if d < best_d:
                    best, best_d = p, d
            if best is None:
                if len(people) >= max_people:
                    continue
                best = {"joints": np.zeros((J, 3)), "tag_sum": 0.0, "count": 0}
                people.append(best)
            best["joints"][j] = (x, y, score)
            best["tag_sum"] += tag
            best["count"] += 1
    return [p["joints"] for p in people if (p["joints"][:, 2] > 0).sum() >= 3]
