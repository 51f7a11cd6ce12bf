"""Plain index ball query (port of ``or4d_tpu/ops/ball_query.py``).

Per query, the first ``nsample`` support indices with squared distance
< radius^2 in scan order; empty slots repeat the first hit (reference
``ball_query_gpu.cu:9-44``). Distances are the direct difference
(dx*dx + dy*dy) + dz*dz, as the TPU kernels and the CUDA kernels of this
port compute them — not the JAX package's |a|^2 + |b|^2 - 2ab expansion, so
boundary hits agree bit for bit with the kernels.

This is the plain version's building block and the tests' oracle; no kernel
sits behind it. It works on any device, in chunks of clouds that bound the
(B, M, N) temporaries.
"""

from __future__ import annotations

import numpy as np
import torch

_CHUNK_ELEMS = 1 << 26  # (clouds, M, N) elements per chunk


def ball_query_with_counts(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                           limit: torch.Tensor | None = None):
    """(idx (B, M, nsample) int64, total (B, M) int64 hit counts).

    A query with no hit gets index 0 in every slot (its ``total`` is 0).
    ``limit`` (B, M): each query scans only its first ``limit`` points."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    r2 = float(np.float32(radius * radius))
    step = max(1, min(B, _CHUNK_ELEMS // max(M * N, 1)))
    idx_out, tot_out = [], []
    pos = torch.arange(N, device=xyz.device)
    for b0 in range(0, B, step):
        p = xyz[b0 : b0 + step, None, :, :]
        q = new_xyz[b0 : b0 + step, :, None, :]
        dx = q[..., 0] - p[..., 0]
        dy = q[..., 1] - p[..., 1]
        dz = q[..., 2] - p[..., 2]
        hit = (dx * dx + dy * dy + dz * dz) < r2  # (b, M, N)
        if limit is not None:
            hit &= pos < limit[b0 : b0 + step, :, None]
        # hits sort first, in scan order; misses after them
        key = torch.where(hit, pos, pos + N)
        k = min(nsample, N)
        top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        is_hit = top < N
        idx = torch.where(is_hit, top, top - N)
        first = torch.where(is_hit[..., :1], idx[..., :1], torch.zeros_like(idx[..., :1]))
        idx = torch.where(is_hit, idx, first)
        if k < nsample:
            idx = torch.cat([idx, first.expand(-1, -1, nsample - k)], dim=-1)
        idx_out.append(idx)
        tot_out.append(hit.sum(-1))
    return torch.cat(idx_out), torch.cat(tot_out)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """``xyz`` (B, N, 3), ``new_xyz`` (B, M, 3) float32 -> (B, M, nsample)
    int32 indices, padded with the first hit."""
    return ball_query_with_counts(radius, nsample, xyz, new_xyz)[0].int()
