"""3-NN feature interpolation: ``three_nn`` and ``three_interpolate`` (port
of ``or4d_tpu/ops/interpolate.py``; reference interpolate_gpu.cu:9-154).

Plain PyTorch on every device: the JAX functions are XLA, with no Pallas
kernel behind them. The neighbours' features are taken by
:func:`gather_rows` (Group-Free's other gathers too), whose backward is
reproducible.

``three_nn`` keeps the JAX package's distance, the expansion
``max(|a|^2 + |b|^2 - 2 a.b, 0)`` (``or4d_tpu/ops/ball_query.py:23``), not
the direct difference the ball query uses. Where an unknown point coincides
with a known one (a Group-Free FP stage interpolates every FPS centroid of
the finer level from the coarser level's subset of them), that expansion is
0 or rounding noise whose square root (up to ~1e-3) decides the
inverse-distance weights; so the rounding must be the JAX package's own.
Compiled by XLA for the CPU, each of the three sums of products is a chain
of fused multiply-adds, ``fma(x2, y2, fma(x1, y1, x0 * y0))``, and the rest
is rounded op by op (so |a|^2 and a.a round alike and a coincident pair is
exactly 0). :func:`pairwise_sqdist` computes exactly that, each
fused step in float64 from float32 operands (the product is exact there)
and rounded to float32 once, as separate elementwise ops, so the card and
the CPU give the same bits; the square root is taken in float64 and
rounded once, as XLA's is. Neighbours are the three smallest distances,
ties to the lowest index (``lax.top_k``), by a stable sort.
"""

from __future__ import annotations

import torch


def _dot3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_c x[..., c] * y[..., c] over 3 channels as XLA's CPU code rounds
    it: ``fma(x2, y2, fma(x1, y1, x0 * y0))``, float32 out."""
    xd, yd = x.double(), y.double()
    acc = (xd[..., 0] * yd[..., 0]).float()
    for c in (1, 2):
        acc = (xd[..., c] * yd[..., c] + acc.double()).float()
    return acc


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` (B, M, 3), ``b`` (B, N, 3) float32 -> (B, M, N) squared
    distances by the expansion, clamped at 0 (the JAX package's
    ``pairwise_sqdist`` as XLA computes it on the CPU)."""
    a, b = a.float(), b.float()
    a2 = _dot3(a, a)[:, :, None]
    b2 = _dot3(b, b)[:, None, :]
    ab = _dot3(a[:, :, None, :], b[:, None, :, :])
    return torch.clamp_min((a2 + b2) - 2.0 * ab, 0.0)


def three_nn(unknown: torch.Tensor, known: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For each unknown point (B, n, 3) its 3 nearest known points (B, m, 3):
    (dist (B, n, 3) euclidean, ascending; idx (B, n, 3) int64 into m)."""
    d2 = pairwise_sqdist(unknown, known)
    top, idx = torch.sort(d2, dim=-1, stable=True)
    # correctly rounded (PyTorch's float32 CPU sqrt is not, always)
    return torch.sqrt(top[..., :3].double()).float(), idx[..., :3]


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``features`` (B, m, C) channel-last, ``idx`` / ``weight`` (B, n, 3) ->
    (B, n, C): the weighted sum of each point's three neighbours' features."""
    return (gather_rows(features, idx) * weight[..., None]).sum(2)


class _SortedGather(torch.autograd.Function):
    """Rows ``x[idx]`` of a 2-D ``x``. The backward adds the cotangent rows
    of a repeated index one by one in the indices' stable sorted order
    (``segment_reduce``), so it is reproducible on the card and the CPU:
    the backwards of ``torch.gather`` and of indexing add them with atomics
    (on the CPU too, when threaded)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        lengths = torch.bincount(idx, minlength=ctx.rows)
        return torch.segment_reduce(g[torch.argsort(idx, stable=True)], "sum", lengths=lengths, axis=0,
                                    unsafe=True), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` (B, N, C), ``idx`` (B, ...) into N -> (B, ..., C), with a
    reproducible backward (:class:`_SortedGather`)."""
    B, N, C = x.shape
    rows = torch.arange(B, device=idx.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    flat = (idx.long() + rows * N).reshape(-1)
    return _SortedGather.apply(x.reshape(B * N, C), flat).reshape(*idx.shape, C)
