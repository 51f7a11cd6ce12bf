"""Floating-point operations of the published model, counted from the
configuration's widths and a batch's valid slots, whatever implements them.

A product of an (n, i) by (i, o) counts 2 n i o. The encoders run once per
valid object and once per valid directed edge (as the published model
runs them), at every grouped slot of every centroid; the GCN over the
valid edges and objects, the heads over the valid slots, the image branch
over every frame. Elementwise work (BN, activations, pooling) is not
counted. A train step counts the forward, and the backward the step needs:
two products a layer (the input's and the weight's gradient), one for the
first layer of each encoder (its input is data), none for a frozen layer.
"""

from __future__ import annotations

import math

from harness.peaks import PEAK_BF16, PEAK_F32
from reference.efficientnet import round_channels, blocks


def _encoder_layers(cfg: dict, c0: int):
    """[(flops a cloud, first)] of one encoder's products."""
    pn = cfg["pointnet2_msg"]
    out = []
    for stage, cin in ((pn["sa1"], c0), (pn["sa2"], 3 + sum(w[-1] for w in pn["sa1"]["mlps"]))):
        for ns, widths in zip(stage["nsamples"], stage["mlps"]):
            c = cin
            for i, w in enumerate(widths):
                out.append((2.0 * stage["npoint"] * ns * c * w, stage is pn["sa1"] and i == 0))
                c = w
    c = 3 + sum(w[-1] for w in pn["sa2"]["mlps"])
    for w in pn["sa3"]["mlp"]:
        out.append((2.0 * pn["sa2"]["npoint"] * c * w, False))
        c = w
    return out


def _b5_per_frame(cfg: dict) -> float:
    im = cfg["image"]
    H = W = im["size"]
    h, w = -(-H // 2), -(-W // 2)
    stem = round_channels(32, im["width_mult"])
    f = 2.0 * h * w * stem * 3 * 9
    last = stem
    for _name, cin, cout, expand, stride, k in blocks(im["width_mult"], im["depth_mult"]):
        mid = cin * expand
        if expand != 1:
            f += 2.0 * h * w * mid * cin
        h, w = -(-h // stride), -(-w // stride)
        se = max(1, cin // 4)
        f += 2.0 * h * w * mid * k * k + 2.0 * 2 * mid * se + 2.0 * h * w * cout * mid
        last = cout
    f += 2.0 * h * w * im["head_features"] * last
    return f


def step_flops(cfg: dict, n_obj: int, n_edge: int, n_scenes: int, train: bool = False) -> float:
    """Operations of one batch with ``n_obj`` valid objects and ``n_edge``
    valid directed edges over ``n_scenes`` scenes."""
    m = cfg["MODEL"]
    D, De, H = m["point_feature_size"], m["edge_feature_size"], m["gcn_hidden_feature_size"]
    C, R = cfg["classes"], cfg["relations"]
    image = cfg.get("IMAGE_INPUT") == "full"
    img = m["FULL_IMAGE_EMBEDDING_SIZE"] if image else 0
    layers = [(f * n_obj, first) for f, first in _encoder_layers(cfg, 6)]
    layers += [(f * n_edge, first) for f, first in _encoder_layers(cfg, 7)]
    gcn = m["N_LAYERS"] * (2.0 * n_edge * ((2 * D + De) * H + H * (2 * H + De)) + 2.0 * n_obj * (H * H + H * D))
    heads = 2.0 * n_obj * (D * 512 + 512 * 256 + 256 * C) + 2.0 * n_edge * (De * 512 + 512 * 256 +
                                                                            (256 + img + 2 * cfg["object_types"]) * R)
    layers += [(gcn, False), (heads, False)]
    total = sum(3.0 * f if train else f for f, first in layers if not first)
    total += sum(2.0 * f if train else f for f, first in layers if first)
    if image:
        im = cfg["image"]
        frames = n_scenes * im["cameras"]
        trunk = frames * _b5_per_frame(cfg)
        head = frames * 2.0 * im["head_features"] * (img // im["cameras"])
        # the trunk is frozen but for conv_head; the reduction trains
        total += trunk + (3.0 * head if train else head)
    return total


def peak_flops(dtype: str) -> float:
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_F32


def mfu_percent(flops_per_call: float, calls: int, seconds: float, dtype: str) -> float | None:
    if seconds <= 0 or calls <= 0 or not math.isfinite(flops_per_call):
        return None
    return 100.0 * flops_per_call * calls / (seconds * peak_flops(dtype))
