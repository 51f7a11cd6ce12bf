"""Shared building blocks: Dense, masked batch norm, MLP stacks (port of
``or4d_tpu/models/layers.py``).

Norms take a validity mask and compute masked moments, so padded slots never
enter the statistics. A BN that tracks running statistics normalizes with
them in eval; in train it normalizes with the masked biased batch moments
and updates the running statistics in place, torch style:
``running = 0.9 * running + 0.1 * batch`` with the unbiased variance.
TripletGCN's BN (``track_running_stats=False``) always uses the masked batch
statistics.

Parameter names follow the JAX package's tree (``dense_i``, ``bn_i``) so the
converter (:mod:`or4d_tpu_torch.convert`) maps one onto the other; a Dense
weight is stored (out, in), the transpose of a flax kernel.
"""

from __future__ import annotations

import contextlib
from collections.abc import Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

from or4d_tpu_torch.parallel.mesh import all_reduce, all_reduce_


def _param(shape, device, std: float = 0.0, generator: torch.Generator | None = None) -> nn.Parameter:
    """A float32 parameter made on the CPU from ``generator`` (normal with
    ``std``; zeros when std == 0) and moved to ``device``."""
    t = torch.zeros(shape, dtype=torch.float32)
    if std:
        t.normal_(0.0, std, generator=generator)
    return nn.Parameter(t.to(device))


class Dense(nn.Module):
    """``y = x @ W^T (+ b)`` computed in ``dtype``; ``dtype=None`` promotes
    the input and parameter dtypes (flax Dense's default)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None,
                 device=None, generator=None, init: str = "lecun"):
        super().__init__()
        fan = in_features if init == "lecun" else (in_features + out_features) / 2.0
        self.weight = _param((out_features, in_features), device, 1.0 / math.sqrt(fan), generator)
        self.bias = _param((out_features,), device) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return nn.functional.linear(x.to(dt), self.weight.to(dt), b)


# elements of one backward temporary of the train BN's chunked backward
# (512 MB in float32)
_BWD_CHUNK = 1 << 27


class _MaskedBatchNormTrain(torch.autograd.Function):
    """Train-mode BN (+ optional ReLU) over every non-channel axis of x
    (B, ..., C) with a per-row mask (B,) or None, saving only its input: the
    backward recomputes the normalized values, so a (B, M, ns, C) grouped
    tensor is held once instead of once per elementwise step.

    Returns (y in x's dtype, batch mean, biased var, count). Arithmetic as
    the JAX package: y = ((x - mean) * rsqrt(var + eps)) * weight + bias in
    f32, then ReLU, then x's dtype.

    ``chunked``: the backward works in row chunks of at most ``_BWD_CHUNK``
    elements, two passes (the channel sums, then dx), so no temporary of
    x's full size is made beside dx itself; slower (the normalized values
    are made twice), it is what keeps the recomputing backward of
    ``TPUConfig.remat`` at the largest batch inside the card. Otherwise one
    pass over whole tensors."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, eps, relu, chunked=False, group=None):
        B, C = x.shape[0], x.shape[-1]
        xf = x.float().reshape(B, -1, C)
        mb = torch.ones(B, device=x.device) if mask is None else mask.float().reshape(B)
        count = mb.sum() * xf.shape[1]
        total = mb @ xf.sum(1)
        if group is not None:  # the sum and the count over every rank's rows, in one call
            both = all_reduce_(torch.cat([total, count.reshape(1)]), group)
            total, count = both[:C], both[C]
        count = torch.clamp(count, min=1.0)
        mean = total / count
        y = xf - mean
        var = all_reduce_(mb @ (y * y).sum(1), group) / count
        rstd = torch.rsqrt(var + eps)
        y.mul_(rstd).mul_(weight).add_(bias)
        if relu:
            y.relu_()
        ctx.save_for_backward(x, mb, weight, bias, mean, rstd, count)
        ctx.relu, ctx.chunked, ctx.group = relu, chunked, group
        ctx.mark_non_differentiable(mean, var, count)
        return y.to(x.dtype).reshape(x.shape), mean, var, count

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar, _gcount):
        x, mb, weight, bias, mean, rstd, count = ctx.saved_tensors
        B, C = x.shape[0], x.shape[-1]
        xr, gr = x.reshape(B, -1, C), gy.reshape(B, -1, C)
        step = max(1, _BWD_CHUNK // max(1, xr[0].numel())) if ctx.chunked else B

        def chunk(lo):
            xhat = (xr[lo:lo + step].float() - mean).mul_(rstd)
            g = gr[lo:lo + step].float()
            if ctx.relu:
                g = g * (xhat * weight + bias > 0)
            return xhat, g, g * weight  # g may be gy itself

        def dx_of(lo, xhat, gx, G, H):
            # mean and var see the valid rows only; every row sees them
            return gx.sub_(mb[lo:lo + step, None, None] * (xhat.mul_(H).add_(G)) / count).mul_(rstd)

        def sums(xhat, g, gx):
            return torch.stack([(g * xhat).sum((0, 1)), g.sum((0, 1)), gx.sum((0, 1)), (gx * xhat).sum((0, 1))])

        def dx_sums(t):
            # dx needs G and H over every rank's rows; dw and db stay this
            # rank's share (the step sums the parameter gradients)
            return t[0], t[1], *all_reduce_(t[2:].clone(), ctx.group)

        if step >= B:
            xhat, g, gx = chunk(0)
            dw, db, G, H = dx_sums(sums(xhat, g, gx))
            dx = dx_of(0, xhat, gx, G, H)
        else:
            total = sum(sums(*chunk(lo)) for lo in range(0, B, step))
            dw, db, G, H = dx_sums(total)
            dx = torch.empty(xr.shape, dtype=x.dtype, device=x.device)
            for lo in range(0, B, step):
                xhat, _g, gx = chunk(lo)
                dx[lo:lo + step] = dx_of(lo, xhat, gx, G, H)
        return dx.to(x.dtype).reshape(x.shape), None, dw, db, None, None, None, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all non-channel axes with row validity masking;
    ``relu=True`` applies a ReLU to the result.

    ``group``: a process group whose ranks hold the other rows of the batch
    (``SGPN.set_mesh``); the batch moments, and in train mode the sums of
    the backward, are then taken over every rank's rows, as the JAX step
    takes them over its global batch. None: this process's rows only."""

    momentum = 0.1

    def __init__(self, features: int, eps: float = 1e-5, track_running_stats: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.track_running_stats = track_running_stats
        self.group = None
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(features, device=device))
            self.register_buffer("running_var", torch.ones(features, device=device))

    def update_running(self, mean: torch.Tensor, var: torch.Tensor, count: torch.Tensor) -> None:
        """``running = 0.9 * running + 0.1 * batch``, with the unbiased variance."""
        with torch.no_grad():
            unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, train: bool = False,
                relu: bool = False, stats: list | None = None) -> torch.Tensor:
        """``mask``: per leading row (B,) in train mode with running
        statistics; broadcastable to ``x.shape[:-1]`` otherwise. ``stats``
        (train mode): the batch moments (mean, var, count) are appended to
        it and the running statistics are left to the caller
        (:meth:`update_running`), as a recomputed forward needs; that path
        (``TPUConfig.remat``) also takes the row-chunked backward."""
        if self.track_running_stats and train:
            y, mean, var, count = _MaskedBatchNormTrain.apply(x, mask, self.weight, self.bias, self.eps, relu,
                                                              stats is not None, self.group)
            if stats is None:
                self.update_running(mean, var, count)
            else:
                stats.append((mean, var, count))
            return y
        if self.track_running_stats:
            mean, var = self.running_mean, self.running_var
        else:  # masked biased moments over every non-channel axis
            xf = x.float().reshape(-1, x.shape[-1])
            m = torch.ones(xf.shape[0], 1, device=x.device) if mask is None else (
                torch.broadcast_to(mask.float(), x.shape[:-1]).reshape(-1, 1))
            count = torch.clamp(all_reduce_(m.sum(), self.group), min=1.0)
            mean = all_reduce((xf * m).sum(0), self.group) / count
            var = all_reduce((((xf - mean) ** 2) * m).sum(0), self.group) / count
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        y = (y * self.weight + self.bias).to(x.dtype)
        return torch.relu(y) if relu else y


class SharedMLP(nn.Module):
    """The pointnet2 per-point MLP: Dense (no bias) -> BN -> ReLU per layer
    (reference build_shared_mlp, pointnet2_modules.py:9-19)."""

    def __init__(self, in_features: int, channels: Sequence[int], dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.depth = len(channels)
        widths = [in_features, *channels]
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", Dense(widths[i], ch, bias=False, dtype=dtype, device=device, generator=generator))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None, train: bool = False) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x), mask, train=train, relu=True)
        return x


class MLP(nn.Module):
    """The TripletGCN ``build_mlp`` (network_TripletGCN.py:11-27): Dense
    (+bias) -> BN (batch statistics, masked) -> ReLU, with BN and ReLU
    skipped on the final layer unless ``on_last``."""

    def __init__(self, in_features: int, dims: Sequence[int], on_last: bool = False, device=None, generator=None):
        super().__init__()
        self.dims = tuple(dims)
        self.on_last = on_last
        widths = [in_features, *dims]
        for i, ch in enumerate(dims):
            self.add_module(f"dense_{i}", Dense(widths[i], ch, device=device, generator=generator))
            if i < len(dims) - 1 or on_last:
                self.add_module(f"bn_{i}", MaskedBatchNorm(ch, track_running_stats=False, device=device))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        n = len(self.dims)
        for i in range(n):
            x = getattr(self, f"dense_{i}")(x)
            if i < n - 1 or self.on_last:
                x = torch.relu(getattr(self, f"bn_{i}")(x, mask))
        return x


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax/TF "SAME" padding of channels-first ``x`` (N, C, *spatial) for a
    window of k per spatial axis at stride s: total = max((ceil(n / s) - 1)
    * s + k - n, 0) a side, the odd pixel after (what ``lax`` pads; a
    symmetric ``padding=`` of a strided convolution is not)."""
    pads = []
    for n in reversed(x.shape[2:]):  # F.pad takes the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full float32 (PyTorch lets them take TF32 by
    default; the JAX reference is float32)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class ConvNd(nn.Module):
    """A flax ``nn.Conv`` / ``nn.ConvTranspose`` over ``nd`` (2 or 3) spatial
    axes of a channels-first input, "SAME" padded, k per axis, one stride. The
    weight is (out, in, *k) for a convolution and (in, out, *k), as
    ``F.conv_transpose{nd}d`` takes it, for a transposed one; normal with
    std 1/sqrt(fan_in), drawn on the CPU from ``generator``. A stride-1
    odd window pads symmetrically inside the convolution; a strided one
    goes through :func:`same_pad` (the odd pixel after); a transposed one
    with stride s pads (k - s) / 2 a side, flax's "SAME" output size."""

    def __init__(self, nd: int, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True,
                 transpose: bool = False, device=None, generator=None):
        super().__init__()
        self.nd, self.k, self.stride, self.transpose = nd, k, stride, transpose
        shape = ((cin, cout) if transpose else (cout, cin)) + (k,) * nd
        w = torch.empty(shape).normal_(0.0, 1.0 / math.sqrt(cin * k ** nd), generator=generator)
        self.weight = nn.Parameter(w.to(device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        if transpose and (k - stride) % 2:
            raise ValueError(f"transposed conv: k - stride must be even, got k={k}, stride={stride}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transpose:
            conv = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[self.nd]
            return conv(x, self.weight, self.bias, self.stride, (self.k - self.stride) // 2)
        conv = {2: F.conv2d, 3: F.conv3d}[self.nd]
        if self.stride == 1 and self.k % 2:
            return conv(x, self.weight, self.bias, 1, self.k // 2)
        return conv(same_pad(x, self.k, self.stride), self.weight, self.bias, self.stride, 0)


class FlaxBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over every axis but the channels (axis 1 of a
    channels-first input). Train mode normalizes with the biased batch
    moments (``F.batch_norm``) and sets the running statistics to
    ``momentum * running + (1 - momentum) * batch``, the batch variance
    biased (flax's; PyTorch's own BN takes the unbiased one and momentum
    0.1). Eval mode normalizes with the running statistics."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.99, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=[0, *range(2, x.dim())], correction=0)
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
