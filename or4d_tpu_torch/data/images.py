"""Full-image loading for the multimodal (``no_gt_image``) config (port of
``or4d_tpu/data/images.py``).

Reference ``data_preparation_utils.py:296-310`` (``load_full_image_data``):
for each of the 6 cameras, the colour-frame index of the scan's pcd index in
``timestamp_to_pcd_and_frames_list.json`` (the list is indexed by
``int(pcd_idx)``, not searched), ``colorimage/camera0{c}_colorimage-{idx}.jpg``,
and timm's eval transform for ``tf_efficientnet_b5_ns``: resize the shorter
side to floor(456 / 0.934) = 488 with bicubic interpolation, centre-crop
456 x 456, scale to [0, 1] and normalise with the ImageNet mean and std.

The JAX package reads the frames with PIL; the port decodes them itself
(:mod:`or4d_tpu_torch.data.jpeg`) and resizes with PIL's own arithmetic
(:func:`resize_bicubic`): the filter's weights computed in double as PIL's
``precompute_coeffs`` does, rounded to 22-bit fixed point, then two integer
passes (horizontal, then vertical), each rounded and clipped to 8 bits. So
the float32 images equal the JAX package's bit for bit. Output is
channels-last float32, the layout the trunk takes.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from or4d_tpu_torch.data.jpeg import read_jpeg

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
B5_INPUT_SIZE = 456
B5_CROP_PCT = 0.934
NUM_CAMERAS = 6
_PRECISION_BITS = 32 - 8 - 2  # PIL Resample.c


def take_dir(root: str | Path, take_idx: int | str) -> Path:
    return Path(root) / f"export_holistic_take{take_idx}_processed"


def frames_list_path(root: str | Path, take_idx: int | str) -> Path:
    return take_dir(root, take_idx) / "timestamp_to_pcd_and_frames_list.json"


def has_images(root: str | Path, take_idx: int | str) -> bool:
    return frames_list_path(root, take_idx).exists()


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's ``bicubic_filter`` (a = -0.5), in its operation order."""
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the whole
    input range: (out, ksize) source indices (clamped; their weight is 0
    past each output's support) and (out, ksize) int64 weights."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = _bicubic(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # summed in order, as PIL does
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    idx = np.minimum(x[None, :] + xmin[:, None], in_size - 1)
    return idx, kk


def _resample(img: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """One of PIL's 8-bit passes along ``axis`` of (H, W, C) int64."""
    idx, kk = _coeffs(img.shape[axis], out_size)
    idx_t = torch.from_numpy(idx).to(img.device)
    kk_t = torch.from_numpy(kk).to(img.device)
    g = img.index_select(axis, idx_t.reshape(-1))  # (.., out * ksize, ..)
    shape = list(img.shape)
    shape[axis:axis + 1] = [out_size, idx.shape[1]]
    g = g.reshape(shape)
    wshape = [1] * g.dim()
    wshape[axis], wshape[axis + 1] = out_size, idx.shape[1]
    ss = (g * kk_t.reshape(wshape)).sum(axis + 1) + (1 << (_PRECISION_BITS - 1))
    return (ss >> _PRECISION_BITS).clamp_(0, 255)


def resize_bicubic(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (height, width, 3) uint8, ``PIL.Image.resize``
    with ``Image.BICUBIC``: horizontal pass, then vertical, each clipped to
    8 bits; a pass whose size does not change is skipped."""
    x = img.long()
    if width != img.shape[1]:
        x = _resample(x, width, 1)
    if height != img.shape[0]:
        x = _resample(x, height, 0)
    return x.to(torch.uint8)


def b5_transform(img: torch.Tensor, image_size: int = B5_INPUT_SIZE, crop_pct: float = B5_CROP_PCT) -> torch.Tensor:
    """timm's eval transform: (H, W, 3) uint8 RGB -> (image_size,
    image_size, 3) float32 (resize the shorter side, centre crop,
    normalise)."""
    scale_size = int(math.floor(image_size / crop_pct))
    h, w = img.shape[:2]
    if w <= h:
        new_w, new_h = scale_size, max(1, int(round(h * scale_size / w)))
    else:
        new_w, new_h = max(1, int(round(w * scale_size / h))), scale_size
    img = resize_bicubic(img, new_w, new_h)
    left, top = (new_w - image_size) // 2, (new_h - image_size) // 2
    # a tensor divisor: a CUDA division by a Python scalar multiplies by its
    # reciprocal, one ulp from numpy's division
    arr = img[top:top + image_size, left:left + image_size].float() / torch.tensor(255.0, device=img.device)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (arr - mean) / std


def load_full_image_data(root: str | Path, take_idx: int | str, pcd_idx: str, image_size: int = B5_INPUT_SIZE,
                         device=None) -> torch.Tensor:
    """(6, image_size, image_size, 3) float32 stack of the scan's six camera
    colour frames (the frames list indexed by ``int(pcd_idx)``), decoded and
    transformed on ``device`` (the CPU by default)."""
    frames = json.loads(frames_list_path(root, take_idx).read_text())
    entry = frames[int(pcd_idx)][1]
    out = []
    for c_idx in range(1, NUM_CAMERAS + 1):
        path = take_dir(root, take_idx) / "colorimage" / f"camera0{c_idx}_colorimage-{entry[f'color_{c_idx}']}.jpg"
        out.append(b5_transform(read_jpeg(path, device), image_size=image_size))
    return torch.stack(out)
