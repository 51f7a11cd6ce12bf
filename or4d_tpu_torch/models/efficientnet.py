"""Image branch: an EfficientNet-B5 trunk and the per-camera reduction
(port of ``or4d_tpu/models/efficientnet.py``).

Reference ``model_utils.py:7-22`` (timm ``tf_efficientnet_b5_ns``,
num_classes=0: pooled 2048-d features) as used at
``scene_graph_prediction_model.py:49-57,98-102``: the trunk is frozen but
for ``conv_head`` (the last 1x1 convolution to 2048), its batch norms always
use their stored statistics, and each camera's pooled features go through
Dense(2048 -> 768 / 6), flattened camera-major into one 768-d scene
embedding that the relation head fuses late.

As the JAX package: width 1.6, depth 2.2, stem 48, head 2048; "SAME"
padding (stride 2 pads the extra pixel after, :func:`same_pad`); frozen BN
with eps 1e-3; squeeze-excite to max(1, in_ch // 4) of the block's input
channels; a residual only where stride is 1 and the widths agree. The trunk
up to ``conv_head`` runs under ``torch.no_grad()`` (the JAX
``stop_gradient``); only ``conv_head`` and ``reduction`` train, ``bn_head``
included in the frozen part (``requires_grad`` is False on every frozen
parameter). Inputs are channels-last (S, 6, H, W, 3), the JAX layout.

The convolutions are ``F.conv2d`` (cuDNN on the card): the JAX package
computes them with XLA, with no Pallas kernel behind the trunk. The trunk
runs in float32 with TF32 off (``cudnn.allow_tf32`` False while it runs),
so the card's embedding follows the CPU's to float32 rounding.

Parameter names follow the flax tree (``trunk.block3_1.conv_dw.weight``),
so :mod:`or4d_tpu_torch.convert` maps one onto the other; a flax kernel
(k, k, in, out) is a torch weight (out, in, k, k), a depthwise one
(k, k, 1, C) is (C, 1, k, k). :func:`timm_parameter_mapping` maps a timm
``tf_efficientnet_b5_ns`` state_dict onto the same names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from or4d_tpu_torch.models.layers import Dense, no_tf32, same_pad

# EfficientNet-B0 base: (expand, channels, repeats, stride, kernel)
_BASE = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
_B5_WIDTH, _B5_DEPTH = 1.6, 2.2
NUM_CAMERAS = 6
# images a trunk call takes at once (eval batches of 64 scenes are 384)
TRUNK_CHUNK = 64


def _round_channels(c: float, mult: float, divisor: int = 8) -> int:
    c *= mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return int(new_c)


def _round_repeats(r: int, mult: float) -> int:
    return int(math.ceil(mult * r))


def _weight(shape, device, generator, fan_in: int) -> nn.Parameter:
    t = torch.empty(shape).normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
    return nn.Parameter(t.to(device))


class Conv(nn.Module):
    """A "SAME"-padded convolution; ``groups`` = channels for depthwise."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1, bias: bool = False,
                 device=None, generator=None):
        super().__init__()
        self.k, self.stride, self.groups = k, stride, groups
        self.weight = _weight((cout, cin // groups, k, k), device, generator, cin // groups * k * k)
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.k > 1:
            x = same_pad(x, self.k, self.stride)
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


class FrozenBN(nn.Module):
    """BatchNorm on its stored statistics only:
    ``(x - mean) * rsqrt(var + 1e-3) * scale + bias`` per channel (NCHW)."""

    def __init__(self, features: int, eps: float = 1e-3, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = lambda t: t[None, :, None, None]
        y = (x - c(self.running_mean)) * c(torch.rsqrt(self.running_var + self.eps))
        return y * c(self.weight) + c(self.bias)


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, se_features: int, device=None, generator=None):
        super().__init__()
        self.reduce = Conv(features, se_features, bias=True, device=device, generator=generator)
        self.expand = Conv(se_features, features, bias=True, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.expand(F.silu(self.reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, expand: int, stride: int, ksize: int, device=None, generator=None):
        super().__init__()
        mid = in_ch * expand
        kw = dict(device=device, generator=generator)
        self.expands = expand != 1
        if self.expands:
            self.conv_pw = Conv(in_ch, mid, **kw)
            self.bn1 = FrozenBN(mid, device=device)
        self.conv_dw = Conv(mid, mid, ksize, stride, groups=mid, **kw)
        self.bn2 = FrozenBN(mid, device=device)
        self.se = SqueezeExcite(mid, max(1, in_ch // 4), **kw)
        self.conv_pwl = Conv(mid, out_ch, **kw)
        self.bn3 = FrozenBN(out_ch, device=device)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.bn1(self.conv_pw(x))) if self.expands else x
        h = self.se(F.silu(self.bn2(self.conv_dw(h))))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


def block_specs():
    """(name, in_ch, out_ch, expand, stride, ksize) of every MBConv block."""
    out, in_ch = [], _round_channels(32, _B5_WIDTH)
    for bi, (expand, ch, reps, stride, k) in enumerate(_BASE):
        out_ch = _round_channels(ch, _B5_WIDTH)
        for ri in range(_round_repeats(reps, _B5_DEPTH)):
            out.append((f"block{bi}_{ri}", in_ch, out_ch, expand, stride if ri == 0 else 1, k))
            in_ch = out_ch
    return out


class EfficientNetB5(nn.Module):
    """Feature trunk: (B, 3, H, W) NCHW -> pooled (B, 2048)."""

    def __init__(self, head_features: int = 2048, device=None, generator=None):
        super().__init__()
        stem = _round_channels(32, _B5_WIDTH)
        self.conv_stem = Conv(3, stem, 3, 2, device=device, generator=generator)
        self.bn_stem = FrozenBN(stem, device=device)
        self.blocks = []
        for name, cin, cout, expand, stride, k in block_specs():
            self.add_module(name, MBConv(cin, cout, expand, stride, k, device=device, generator=generator))
            self.blocks.append(name)
            last = cout
        self.conv_head = Conv(last, head_features, device=device, generator=generator)
        self.bn_head = FrozenBN(head_features, device=device)
        for name, p in self.named_parameters():
            p.requires_grad_(name.startswith("conv_head."))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The frozen part, up to ``conv_head``'s input (no autograd graph)."""
        with torch.no_grad(), no_tf32():
            h = F.silu(self.bn_stem(self.conv_stem(x)))
            for name in self.blocks:
                h = getattr(self, name)(h)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = F.silu(self.bn_head(self.conv_head(h)))
        return h.mean(dim=(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


class ImageBranch(nn.Module):
    """The 6-camera scene embedding (scene_graph_prediction_model.py:98-102):
    (S, 6, H, W, 3) channels-last -> (S, embedding_size); the trunk takes
    at most :data:`TRUNK_CHUNK` images a call."""

    def __init__(self, embedding_size: int = 768, device=None, generator=None):
        super().__init__()
        self.embedding_size = embedding_size
        self.trunk = EfficientNetB5(device=device, generator=generator)
        self.reduction = Dense(2048, embedding_size // NUM_CAMERAS, device=device, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        S, C = images.shape[:2]
        flat = images.reshape((S * C,) + tuple(images.shape[2:])).permute(0, 3, 1, 2).float()
        feats = torch.cat([self.trunk.head(self.trunk.features(flat[i:i + TRUNK_CHUNK].contiguous()))
                           for i in range(0, S * C, TRUNK_CHUNK)])
        return self.reduction(feats).reshape(S, C * (self.embedding_size // C))


def is_trainable(name: str) -> bool:
    """Whether an SGPN parameter trains: everything outside the image
    branch, and inside it only ``conv_head`` and ``reduction``
    (``sgpn_trainable_labels``, or4d_tpu/models/efficientnet.py:186-198)."""
    parts = name.split(".")
    return "image_branch" not in parts or "conv_head" in parts or "reduction" in parts


def timm_parameter_mapping():
    """timm ``tf_efficientnet_b5_ns`` state_dict keys -> the trunk's
    state_dict keys, as (timm_key, port_key) pairs; every trunk parameter
    and statistic once. Stage 0 is timm's DepthwiseSeparableConv (conv_dw,
    bn1, se, conv_pw, bn2), whose conv_pw/bn2 land on the port block's
    conv_pwl/bn3; stages 1-6 are InvertedResiduals (conv_pw, bn1, conv_dw,
    bn2, se, conv_pwl, bn3). Shapes need no transposing: both are torch
    layouts."""
    def bn(timm_name, port_name):
        for a, b in (("weight", "weight"), ("bias", "bias"), ("running_mean", "running_mean"),
                     ("running_var", "running_var")):
            yield f"{timm_name}.{a}", f"{port_name}.{b}"

    yield "conv_stem.weight", "conv_stem.weight"
    yield from bn("bn1", "bn_stem")
    for bi, (expand, _ch, reps, _stride, _k) in enumerate(_BASE):
        for ri in range(_round_repeats(reps, _B5_DEPTH)):
            t, p = f"blocks.{bi}.{ri}", f"block{bi}_{ri}"
            if expand == 1:
                yield f"{t}.conv_dw.weight", f"{p}.conv_dw.weight"
                yield from bn(f"{t}.bn1", f"{p}.bn2")
                proj, proj_bn = "conv_pw", f"{t}.bn2"
            else:
                yield f"{t}.conv_pw.weight", f"{p}.conv_pw.weight"
                yield from bn(f"{t}.bn1", f"{p}.bn1")
                yield f"{t}.conv_dw.weight", f"{p}.conv_dw.weight"
                yield from bn(f"{t}.bn2", f"{p}.bn2")
                proj, proj_bn = "conv_pwl", f"{t}.bn3"
            for part in ("reduce", "expand"):
                yield f"{t}.se.conv_{part}.weight", f"{p}.se.{part}.weight"
                yield f"{t}.se.conv_{part}.bias", f"{p}.se.{part}.bias"
            yield f"{t}.{proj}.weight", f"{p}.conv_pwl.weight"
            yield from bn(proj_bn, f"{p}.bn3")
    yield "conv_head.weight", "conv_head.weight"
    yield from bn("bn2", "bn_head")


def import_timm_state_dict(state_dict: dict, trunk: EfficientNetB5) -> dict[str, torch.Tensor]:
    """The trunk's state_dict from a timm ``tf_efficientnet_b5_ns`` one:
    every trunk tensor must be covered with its shape; missing, unmapped
    (``num_batches_tracked`` aside) or mismatched keys raise."""
    expected = trunk.state_dict()
    out = {}
    for timm_key, key in timm_parameter_mapping():
        if timm_key not in state_dict:
            raise KeyError(f"state_dict missing {timm_key}")
        t = torch.as_tensor(state_dict[timm_key])
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(t.shape)} vs {tuple(expected[key].shape)}")
        out[key] = t.to(dtype=expected[key].dtype, device=expected[key].device)
    mapped = {k for k, _ in timm_parameter_mapping()}
    extra = [k for k in state_dict if k not in mapped and not k.endswith("num_batches_tracked")]
    if extra:
        raise KeyError(f"unmapped state_dict keys: {extra[:5]}{'...' if len(extra) > 5 else ''}")
    if set(out) != set(expected):
        raise KeyError(f"trunk keys not covered: {sorted(set(expected) - set(out))[:5]}")
    return out
