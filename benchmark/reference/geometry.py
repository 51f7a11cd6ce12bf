"""Furthest point sampling and the ball query of PointNet++, plain.

Semantics of the published CUDA ops (pointnet2 ``sampling_gpu.cu``,
``ball_query_gpu.cu``): FPS starts at index 0, keeps a running minimum of
squared distances and takes the point with the largest one next, ties to
the lowest index; a point with |p|^2 <= 1e-3 is never taken and never
lowers its running distance below -1. The ball query takes, per centroid,
the first ``ns`` points in scan order with squared distance < r^2 and
repeats the first hit in the empty slots (index 0 when there is none).
Squared distances are (dx*dx + dy*dy) + dz*dz, each operation rounded to
float32, and r^2 is rounded to float32 from the double product.
"""

from __future__ import annotations

import numpy as np
import torch

MAG_EPS = float(np.float32(1e-3))
_FPS_ROWS = 8192  # clouds a FPS pass takes at once
_BQ_ELEMS = 1 << 27  # (clouds, M, N) elements a ball-query block takes


def r2_of(radius: float) -> float:
    return float(np.float32(radius * radius))


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int64 indices."""
    out = []
    for b0 in range(0, xyz.shape[0], _FPS_ROWS):
        out.append(_fps_block(xyz[b0:b0 + _FPS_ROWS], npoint))
    return torch.cat(out)


def _fps_block(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B = xyz.shape[0]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    mag = x * x + y * y + z * z
    mind = torch.where(mag > MAG_EPS, torch.full_like(mag, float("inf")), torch.full_like(mag, -1.0))
    idx = torch.zeros(B, npoint, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    sel = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        dx = x - x[rows, sel][:, None]
        dy = y - y[rows, sel][:, None]
        dz = z - z[rows, sel][:, None]
        mind = torch.minimum(mind, dx * dx + dy * dy + dz * dz)
        sel = torch.argmax(mind, dim=1)
        idx[:, j] = sel
    return idx


def gather_points(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, ...) int -> (B, ..., C)."""
    B = xyz.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(xyz, 1, flat[..., None].expand(-1, -1, xyz.shape[-1]))
    return out.reshape(tuple(idx.shape) + (xyz.shape[-1],))


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, ns: int, with_total: bool = False):
    """(B, M, ns) int64 indices; with ``with_total`` also (B, M) hit counts."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    r2 = r2_of(radius)
    step = max(1, _BQ_ELEMS // max(M * N, 1))
    pos = torch.arange(N, device=xyz.device)
    k = min(ns, N)
    idx_out, tot_out = [], []
    for b0 in range(0, B, step):
        p = xyz[b0:b0 + step, None, :, :]
        q = new_xyz[b0:b0 + step, :, None, :]
        dx = p[..., 0] - q[..., 0]
        dy = p[..., 1] - q[..., 1]
        dz = p[..., 2] - q[..., 2]
        hit = (dx * dx + dy * dy + dz * dz) < r2
        key = torch.where(hit, pos, pos + N)
        top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        is_hit = top < N
        idx = torch.where(is_hit, top, top - N)
        first = torch.where(is_hit[..., :1], idx[..., :1], torch.zeros_like(idx[..., :1]))
        idx = torch.where(is_hit, idx, first)
        if k < ns:
            idx = torch.cat([idx, first.expand(-1, -1, ns - k)], dim=-1)
        idx_out.append(idx)
        if with_total:
            tot_out.append(hit.sum(-1))
    idx = torch.cat(idx_out)
    return (idx, torch.cat(tot_out)) if with_total else idx
