"""The image branch, plain: timm's ``tf_efficientnet_b5_ns`` trunk
(width 1.6, depth 2.2, stem 48, head 2048, TF "SAME" padding, BN eps 1e-3
on stored statistics, squeeze-excite to a quarter of the block's input
channels, SiLU) pooled to 2048 features a frame, then one Dense(2048 ->
768 / 6) per frame, concatenated camera-major into the scene's 768-d
embedding (4D-OR ``model_utils.py``, ``scene_graph_prediction_model.py``).
Channels-first float32; frames come channels-last (S, 6, H, W, 3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.precision import Precision

BN_EPS = 1e-3
# EfficientNet-B0: (expand, channels, repeats, stride, kernel) per stage
_B0 = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3), (6, 112, 3, 1, 5),
       (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
_FRAMES_PER_CALL = 32


def round_channels(c: float, mult: float, divisor: int = 8) -> int:
    c *= mult
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    return int(new_c + divisor if new_c < 0.9 * c else new_c)


def blocks(width: float, depth: float):
    """(name, in, out, expand, stride, kernel) of every MBConv block."""
    out, cin = [], round_channels(32, width)
    for bi, (expand, ch, reps, stride, k) in enumerate(_B0):
        cout = round_channels(ch, width)
        for ri in range(int(math.ceil(depth * reps))):
            out.append((f"block{bi}_{ri}", cin, cout, expand, stride if ri == 0 else 1, k))
            cin = cout
    return out


def param_specs(cfg: dict, prefix: str = "image_branch"):
    im = cfg["image"]
    w, d, head = im["width_mult"], im["depth_mult"], im["head_features"]
    t = f"{prefix}.trunk"
    out = []

    def conv(name, cout, cin_g, k, bias=False):
        out.append((f"{name}.weight", (cout, cin_g, k, k), "conv", cin_g * k * k))
        if bias:
            out.append((f"{name}.bias", (cout,), "bias", 0))

    def bn(name, c):
        out.extend((f"{name}.{k}", (c,), f"bn_{k}", 0) for k in ("weight", "bias", "running_mean", "running_var"))

    stem = round_channels(32, w)
    conv(f"{t}.conv_stem", stem, 3, 3)
    bn(f"{t}.bn_stem", stem)
    last = stem
    for name, cin, cout, expand, _s, k in blocks(w, d):
        mid = cin * expand
        if expand != 1:
            conv(f"{t}.{name}.conv_pw", mid, cin, 1)
            bn(f"{t}.{name}.bn1", mid)
        conv(f"{t}.{name}.conv_dw", mid, 1, k)
        bn(f"{t}.{name}.bn2", mid)
        se = max(1, cin // 4)
        conv(f"{t}.{name}.se.reduce", se, mid, 1, bias=True)
        conv(f"{t}.{name}.se.expand", mid, se, 1, bias=True)
        conv(f"{t}.{name}.conv_pwl", cout, mid, 1)
        bn(f"{t}.{name}.bn3", cout)
        last = cout
    conv(f"{t}.conv_head", head, last, 1)
    bn(f"{t}.bn_head", head)
    emb = cfg["MODEL"]["FULL_IMAGE_EMBEDDING_SIZE"]
    out.append((f"{prefix}.reduction.weight", (emb // im["cameras"], head), "dense", head))
    out.append((f"{prefix}.reduction.bias", (emb // im["cameras"],), "bias", 0))
    return out


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """TF "SAME": (ceil(n / s) - 1) * s + k - n pixels a spatial axis, the
    odd one after."""
    pads = []
    for n in reversed(x.shape[2:]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _bn(P, pre, x):
    c = lambda t: t[None, :, None, None]
    return (x - c(P[f"{pre}.running_mean"])) * c(torch.rsqrt(P[f"{pre}.running_var"] + BN_EPS)) \
        * c(P[f"{pre}.weight"]) + c(P[f"{pre}.bias"])


def _conv(P, pre, x, k, stride, groups, prec, bias=False):
    if k > 1:
        x = same_pad(x, k, stride)
    return prec.conv2d(x, P[f"{pre}.weight"], P[f"{pre}.bias"] if bias else None, stride, groups)


def trunk(P, cfg, x: torch.Tensor, prefix: str, prec: Precision) -> torch.Tensor:
    """(B, 3, H, W) -> (B, head) pooled features."""
    im = cfg["image"]
    t = f"{prefix}.trunk"
    h = F.silu(_bn(P, f"{t}.bn_stem", _conv(P, f"{t}.conv_stem", x, 3, 2, 1, prec)))
    for name, cin, cout, expand, stride, k in blocks(im["width_mult"], im["depth_mult"]):
        b = f"{t}.{name}"
        mid = cin * expand
        y = F.silu(_bn(P, f"{b}.bn1", _conv(P, f"{b}.conv_pw", h, 1, 1, 1, prec))) if expand != 1 else h
        y = F.silu(_bn(P, f"{b}.bn2", _conv(P, f"{b}.conv_dw", y, k, stride, mid, prec)))
        s = y.mean(dim=(2, 3), keepdim=True)
        s = _conv(P, f"{b}.se.expand", F.silu(_conv(P, f"{b}.se.reduce", s, 1, 1, 1, prec, bias=True)), 1, 1, 1,
                  prec, bias=True)
        y = _bn(P, f"{b}.bn3", _conv(P, f"{b}.conv_pwl", y * torch.sigmoid(s), 1, 1, 1, prec))
        h = y + h if stride == 1 and cin == cout else y
    h = F.silu(_bn(P, f"{t}.bn_head", _conv(P, f"{t}.conv_head", h, 1, 1, 1, prec)))
    return h.mean(dim=(2, 3))


def embedding(P, cfg, images: torch.Tensor, prec: Precision | None = None, prefix: str = "image_branch"):
    """(S, cameras, H, W, 3) frames -> (S, embedding) scene embeddings."""
    prec = prec or Precision()
    S, C = images.shape[:2]
    flat = images.reshape((S * C,) + tuple(images.shape[2:])).permute(0, 3, 1, 2).float()
    feats = torch.cat([trunk(P, cfg, flat[i:i + _FRAMES_PER_CALL].contiguous(), prefix, prec)
                       for i in range(0, S * C, _FRAMES_PER_CALL)])
    red = prec.linear(feats, P[f"{prefix}.reduction.weight"], P[f"{prefix}.reduction.bias"])
    return red.reshape(S, -1)
