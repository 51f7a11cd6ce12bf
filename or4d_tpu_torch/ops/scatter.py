"""Segment ops for graph message passing (port of ``or4d_tpu/ops/scatter.py``),
the reference's ``torch_scatter.scatter`` (network_TripletGCN.py:54-58):
rows of ``data`` (E, ...) summed, maxed or averaged into ``num_segments``
buckets by ``segment_ids`` (E,). Ids outside [0, num_segments) are dropped,
as ``jax.ops.segment_*`` drops them. The port's TripletGCN sums its
messages by a one-hot product instead (one summation order on every run).
"""

from __future__ import annotations

import torch


def _bucketed(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    return data[keep], ids[keep]


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of each segment's rows; 0 for an empty segment."""
    rows, ids = _bucketed(data, segment_ids, num_segments)
    return data.new_zeros((num_segments,) + tuple(data.shape[1:])).index_add(0, ids, rows)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Largest of each segment's rows; an empty segment is -inf (the
    lowest value for an integer dtype), as in JAX."""
    rows, ids = _bucketed(data, segment_ids, num_segments)
    lowest = -torch.inf if data.dtype.is_floating_point else torch.iinfo(data.dtype).min
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), lowest)
    index = ids.reshape((-1,) + (1,) * (rows.dim() - 1)).expand_as(rows)
    return out.scatter_reduce(0, index, rows, "amax", include_self=True)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of each segment's rows (``data`` (E, C)); 0 for an empty one."""
    sums = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(data.shape[0], dtype=data.dtype, device=data.device), segment_ids, num_segments)
    return sums / torch.clamp(counts, min=1.0)[:, None]
