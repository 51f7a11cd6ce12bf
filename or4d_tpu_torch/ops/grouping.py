"""Point grouping ops (port of ``or4d_tpu/ops/grouping.py``): the
reference's ``group_points`` and its QueryAndGroup / GroupAll modules
(group_points_gpu.cu, pointnet2_utils.py:283-383).

The gathers are ``torch.gather`` (XLA gathers in the JAX package, outside
any Pallas kernel); autograd gives the scatter-add backward. The ball query
of :func:`query_and_group` is TPU row 8's kernel at one scale on a CUDA
tensor (``ops/ball_query_multiscale.py``, as ``models/groupfree.py`` calls
it) and the plain index ball query (``ops/ball_query.py``) on the CPU.
"""

from __future__ import annotations

import torch

from or4d_tpu_torch.ops.ball_query_multiscale import ball_query_multiscale


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Channels at sampled indices, the reference ``gather_operation``
    (sampling_gpu.cu:8-57): ``points`` (B, C, N), ``idx`` (B, M) int ->
    (B, C, M)."""
    return torch.gather(points, 2, idx.long()[:, None, :].expand(-1, points.shape[1], -1))


def grouping_operation(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbourhood features: ``features`` (B, C, N), ``idx``
    (B, M, S) int -> (B, C, M, S)."""
    B, C, _N = features.shape
    _, M, S = idx.shape
    flat = torch.gather(features, 2, idx.long().reshape(B, 1, M * S).expand(-1, C, -1))
    return flat.reshape(B, C, M, S)


def query_and_group(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: torch.Tensor | None = None, use_xyz: bool = True) -> torch.Tensor:
    """Ball query + gather + centre-relative xyz, the reference
    ``QueryAndGroup``: ``xyz`` (B, N, 3), ``new_xyz`` (B, M, 3) float32,
    ``features`` (B, C, N) or None -> (B, 3 + C, M, nsample) with
    ``use_xyz`` (the reference layout), (B, C, M, nsample) without."""
    (idx,) = ball_query_multiscale(((radius, nsample),), xyz.contiguous(), new_xyz.contiguous())
    grouped_xyz = grouping_operation(xyz.transpose(1, 2), idx) - new_xyz.transpose(1, 2)[..., None]
    if features is not None:
        grouped_features = grouping_operation(features, idx)
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_features], dim=1)
        return grouped_features
    if not use_xyz:
        raise ValueError("cannot have neither features nor xyz")
    return grouped_xyz


def group_all(xyz: torch.Tensor, features: torch.Tensor | None = None, use_xyz: bool = True) -> torch.Tensor:
    """The reference ``GroupAll``, the whole cloud as one group: ``xyz``
    (B, N, 3), ``features`` (B, C, N) -> (B, 3 + C, 1, N)."""
    grouped_xyz = xyz.transpose(1, 2)[:, :, None, :]
    if features is not None:
        grouped_features = features[:, :, None, :]
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_features], dim=1)
        return grouped_features
    return grouped_xyz
