"""PointNet++ MSG feature encoder, eval and train forward (port of
``or4d_tpu/models/pointnet2.py``).

Architecture (reference pointnet2_msg_cls.py:45-78):

  SA1 (npoint 512): scales (r=0.1, ns=16, mlp [C, 64, 64]),
                            (r=0.2, ns=32, mlp [C, 64, 128])
  SA2 (npoint 128): scales (r=0.2, ns=32, mlp [195, 128, 128]),
                            (r=0.4, ns=64, mlp [195, 128, 128])
  SA3 (global):     mlp [259, 256, 256]

with use_xyz=True. Channel-last throughout; geometry stays float32.

Each SA scale runs as one fused kernel call (:mod:`or4d_tpu_torch.ops.sa_group_mlp`)
on the delayed-aggregation form of its first layer, W @ [p - q, f] =
W @ [p, f] - W_xyz @ q, with both eval BNs folded to affines. Supports wider
than one 512-point chunk take the search bounds the FPS kernel derives from
its per-chunk hit counts (``furthest_point_sample_with_bounds``) and build
the layer-1 rows inside the kernel from the channel-major raw
[xyz|features] plane (the JAX package's v4 raw mode); narrower supports
(SA2's 512 centroids) use a precomputed layer-1 plane. The relation
encoder's paired mode runs SA1 once per unordered pair and emits both
directions.

Training keeps exact masked batch statistics, so each scale's grouped
layer-1 rows come out of a grouping kernel with a backward, and
``DelayedSharedMLP.post`` runs BN/ReLU and the second layer on them in
PyTorch before the max over the slots. Supports wider than one chunk (SA1)
take the FPS kernel's search bounds and, with ``train_raw``
(the default), group rows built from the raw plane
(:func:`~or4d_tpu_torch.ops.ball_query_group_raw.ball_query_group_raw`, W0's
gradient only: their features are model inputs); without it, rows of the
layer-1 plane A (:func:`~or4d_tpu_torch.ops.ball_query_group.ball_query_group_gated`,
dA, so the features get their gradient through A). Narrower supports (SA2)
group rows of A with
:func:`~or4d_tpu_torch.ops.ball_query_group.ball_query_group`. The encoder
sets ``train_raw`` on SA1 only.

Serving mode (:mod:`or4d_tpu_torch.serving`) hands SA1 a cache of its
weight-independent geometry (FPS centroids and the grouped [p_abs | f]
planes per scale); SA1 then runs only its MLP chain on the cached planes,
one :mod:`or4d_tpu_torch.ops.serving_sa1_mlp` kernel call per scale, and
SA2/SA3 run as in cold eval.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from or4d_tpu_torch.models.layers import Dense, MaskedBatchNorm, SharedMLP
from or4d_tpu_torch.ops.ball_query_group import ball_query_group, ball_query_group_gated
from or4d_tpu_torch.ops.ball_query_group_raw import ball_query_group_raw
from or4d_tpu_torch.ops.fps import CHUNK, furthest_point_sample, furthest_point_sample_with_bounds
from or4d_tpu_torch.ops.sa_group_mlp import sa_group_mlp
from or4d_tpu_torch.ops.serving_sa1_mlp import serving_sa1_mlp

SA1_RADII = (0.1, 0.2)
SA2_RADII = (0.2, 0.4)


@dataclasses.dataclass(frozen=True)
class SAScale:
    radius: float
    nsample: int
    mlp: tuple[int, ...]  # widths after the input


class DelayedSharedMLP(nn.Module):
    """SharedMLP for grouped neighbourhoods with delayed aggregation.
    Parameter names mirror SharedMLP (dense_i/bn_i)."""

    def __init__(self, in_features: int, channels: Sequence[int], dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.in_features = in_features
        self.channels = tuple(channels)
        self.dtype = dtype
        widths = [in_features, *channels]
        for i, ch in enumerate(channels):
            self.add_module(f"dense_{i}", Dense(widths[i], ch, bias=False, dtype=dtype, device=device, generator=generator))
            self.add_module(f"bn_{i}", MaskedBatchNorm(ch, device=device))

    def w0_matrix(self) -> torch.Tensor:
        """The layer-1 weight (C0, C1) in the compute dtype."""
        return self.dense_0.weight.t().to(self.dtype).contiguous()

    def bq_term(self, new_xyz: torch.Tensor) -> torch.Tensor:
        """Bq = dense_0([q, 0...]): the per-query term, in the compute dtype."""
        pad = new_xyz.new_zeros(new_xyz.shape[:-1] + (self.in_features - 3,))
        return self.dense_0(torch.cat([new_xyz, pad], dim=-1).to(self.dtype)).contiguous()

    def pre(self, xyz: torch.Tensor, features: torch.Tensor | None) -> torch.Tensor:
        """Per-support layer-1 plane A = dense_0([p, f_p]) (B, N, C1)."""
        x = xyz if features is None else torch.cat([xyz, features.to(xyz.dtype)], dim=-1)
        return self.dense_0(x.to(self.dtype)).contiguous()

    def post(self, grouped: torch.Tensor, Bq: torch.Tensor, mask: torch.Tensor | None = None,
             train: bool = False, stats: list | None = None) -> torch.Tensor:
        """BN/ReLU and the remaining layers on grouped layer-1 rows
        (B, M, ns, C1) minus Bq (B, M, C1); ``mask`` (B,) rows. ``stats``:
        each train BN's batch moments go there instead of into its running
        statistics (``MaskedBatchNorm.forward``)."""
        h = self.bn_0(grouped - Bq[:, :, None, :], mask, train=train, relu=True, stats=stats)
        for i in range(1, len(self.channels)):
            h = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(h), mask, train=train, relu=True, stats=stats)
        return h

    def post_pooled_remat(self, grouped: torch.Tensor, Bq: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """``post(...).amax(dim=2)`` in train mode under activation
        checkpointing (``TPUConfig.remat``): only the grouped rows (the
        grouping kernel's output) and Bq are saved, and the BN/ReLU/dense
        chain is recomputed in the backward, the selective remat of the JAX
        package's train step (or4d_tpu/train/loop.py:113-126). The running
        statistics are updated once, from the forward's batch moments."""

        def chain(g, bq):
            stats = []
            out = self.post(g, bq, mask, train=True, stats=stats).amax(dim=2)
            return (out, *[t for st in stats for t in st])

        out, *flat = checkpoint(chain, grouped, Bq, use_reentrant=False)
        for i in range(len(self.channels)):
            getattr(self, f"bn_{i}").update_running(*flat[3 * i:3 * i + 3])
        return out

    def fused_eval_params(self):
        """(a0, b0, W1, a1, b1): both eval BNs folded to per-channel affines,
        probed through the BN modules with 0 and 1 as the JAX package does
        (pointnet2.py:149-164), and the second layer's weight (C1, C2)."""
        if len(self.channels) != 2:
            raise ValueError("the fused eval SA stage takes 2-layer MLPs")
        c1, c2 = self.channels
        dev = self.dense_0.weight.device

        def affine(bn, c):
            z = torch.zeros(1, c, device=dev)
            b = bn(z)[0]
            return (bn(z + 1.0)[0] - b).contiguous(), b.contiguous()

        a0, b0 = affine(self.bn_0, c1)
        a1, b1 = affine(self.bn_1, c2)
        W1 = self.dense_1.weight.t().to(self.dtype).contiguous()
        return a0, b0, W1, a1, b1


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping set abstraction.

    ``forward(xyz (B, N, 3), features (B, N, C) or None, features_alt)`` ->
    (new_xyz (B, npoint, 3), features (B, npoint, sum of scale widths)), or
    with ``features_alt`` (paired, eval only) (B, npoint, 2, sum of widths):
    the directions differ only in the last feature channel. ``train=True``
    takes batch statistics over the rows that ``mask`` (B,) marks valid.
    With ``cache`` (a serving ``SA1Cache``, eval only) ``xyz`` and
    ``features`` are not read: the cached centroids and planes stand in for
    FPS and the ball query. ``train_raw`` picks the train grouping on
    supports wider than one chunk (see the module docstring); it is exact
    for parameter training only where the features are model inputs.
    ``remat`` recomputes each scale's BN/ReLU/dense chain in the backward
    (:meth:`DelayedSharedMLP.post_pooled_remat`).
    """

    def __init__(self, in_features: int, npoint: int, scales: Sequence[SAScale], dtype=torch.float32,
                 device=None, generator=None, train_raw: bool = True, remat: bool = False):
        super().__init__()
        self.npoint = npoint
        self.scales = tuple(scales)
        self.dtype = dtype
        self.train_raw = train_raw
        self.remat = remat
        for si, sc in enumerate(self.scales):
            self.add_module(f"mlp_{si}", DelayedSharedMLP(in_features, sc.mlp, dtype, device, generator))

    def _scale_spec(self) -> tuple[tuple[float, int], ...]:
        return tuple((sc.radius, sc.nsample) for sc in self.scales)

    def forward(self, xyz, features, features_alt=None, mask=None, train: bool = False, cache=None):
        if cache is not None:
            if train or features_alt is not None:
                raise ValueError("the SA1 serving cache is an unpaired eval path")
            return cache.new_xyz, self._cached_forward(cache)
        if train:
            if features_alt is not None:
                raise ValueError("paired SA is an eval path")
            return self._train_forward(xyz.contiguous(), features, mask)
        B, N, _ = xyz.shape
        xyz = xyz.contiguous()
        paired = features_alt is not None
        needs = [None] * len(self.scales)
        if N > CHUNK:
            # the FPS kernel's bounds (from its per-chunk hit counts) cut each query's search
            idx, needs = furthest_point_sample_with_bounds(xyz, self.npoint, self._scale_spec())
        else:
            idx = furthest_point_sample(xyz, self.npoint)
        new_xyz = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()

        raw = None
        if paired or N > CHUNK:
            parts = [xyz] + ([] if features is None else [features.to(xyz.dtype)])
            if paired:
                parts.append(features_alt[..., -1:].to(xyz.dtype))
            raw = torch.cat(parts, dim=-1).to(self.dtype).transpose(1, 2).contiguous()  # (B, C0[+1], N)
        outs = []
        for si, sc in enumerate(self.scales):
            m = getattr(self, f"mlp_{si}")
            a0, b0, W1, a1, b1 = m.fused_eval_params()
            kw = dict(raw=raw, W0=m.w0_matrix(), paired=paired) if raw is not None else dict(A=m.pre(xyz, features))
            outs.append(sa_group_mlp(xyz, new_xyz, sc.radius, sc.nsample, m.bq_term(new_xyz), a0, b0, W1, a1, b1,
                                     need=needs[si], **kw))
        if paired:
            # per scale (B, M, 2*C2) -> (B, M, 2, C2): direction before channels
            outs = [o.view(B, self.npoint, 2, -1) for o in outs]
        return new_xyz, torch.cat(outs, dim=-1)

    def _cached_forward(self, cache) -> torch.Tensor:
        """Per scale: the serving kernel on the cached planes, with the
        per-query term of the cached centroids and the folded eval BNs."""
        if cache.c0 != self.mlp_0.in_features or len(cache.grouped) != len(self.scales):
            raise ValueError(f"cache of {cache.c0} channels and {len(cache.grouped)} scales does not fit an SA "
                             f"stage of {self.mlp_0.in_features} channels and {len(self.scales)} scales")
        outs = []
        for si, (sc, g) in enumerate(zip(self.scales, cache.grouped)):
            if g.shape[2] != sc.nsample:
                raise ValueError(f"scale {si}: the cache holds {g.shape[2]} slots, the stage takes {sc.nsample}")
            m = getattr(self, f"mlp_{si}")
            outs.append(serving_sa1_mlp(g, m.bq_term(cache.new_xyz), m.w0_matrix(), *m.fused_eval_params()))
        return torch.cat(outs, dim=-1)

    def _train_forward(self, xyz, features, mask):
        """Per scale: grouped layer-1 rows from a grouping kernel, then
        ``post`` and the max over the slots. Supports wider than one chunk
        search within the FPS counts' bounds and group from the raw
        [xyz|features] plane (``train_raw``) or from the layer-1 plane."""
        N = xyz.shape[1]
        wide = N > CHUNK
        if wide:
            idx, needs = furthest_point_sample_with_bounds(xyz, self.npoint, self._scale_spec())
        else:
            idx = furthest_point_sample(xyz, self.npoint)
        if wide and self.train_raw:
            parts = [xyz] + ([] if features is None else [features.to(xyz.dtype)])
            raw = torch.cat(parts, dim=-1).to(self.dtype).transpose(1, 2).contiguous()  # (B, C0, N)
        new_xyz = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
        outs = []
        for si, sc in enumerate(self.scales):
            m = getattr(self, f"mlp_{si}")
            if wide and self.train_raw:
                g = ball_query_group_raw(xyz, new_xyz, sc.radius, sc.nsample, m.w0_matrix(), raw, needs[si])
            elif wide:
                g = ball_query_group_gated(xyz, new_xyz, sc.radius, sc.nsample, m.pre(xyz, features), needs[si])
            else:
                g = ball_query_group(xyz, new_xyz, sc.radius, sc.nsample, m.pre(xyz, features))
            Bq = m.bq_term(new_xyz)
            outs.append(m.post_pooled_remat(g, Bq, mask) if self.remat else m.post(g, Bq, mask, train=True).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class SetAbstractionAll(nn.Module):
    """Global set abstraction (PointnetSAModule with GroupAll)."""

    def __init__(self, in_features: int, mlp: Sequence[int], dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(in_features, mlp, dtype, device, generator)

    def forward(self, xyz, features, mask=None, train: bool = False):
        x = torch.cat([xyz.to(features.dtype), features], dim=-1)
        return self.mlp(x.to(self.dtype), mask, train=train).amax(dim=1)


class PointNet2MSGEncoder(nn.Module):
    """The reference PointNetfeat2: MSG backbone as a global feature
    extractor. ``forward(pc (B, P, input_dim))`` -> (B, out_size).

    ``paired=True`` (eval): ``pc`` is (B, P, 8) — [xyz, rgb, mask_fwd,
    mask_rev] pair-shared relation crops, one row per unordered pair.
    Returns (2B, out_size) interleaved [pair0-fwd, pair0-rev, pair1-fwd,
    ...]; SA1 runs once per pair, SA2/SA3 per direction.

    ``train=True``: batch statistics over the rows ``mask`` (B,) marks
    valid, running statistics updated.

    ``sa1_cache`` (serving, eval, unpaired): SA1 runs on the cached geometry
    and ``pc`` is not read (it may be None).

    ``train_raw`` is SA1's (its features are model inputs); SA2's features
    carry gradients, so SA2 always groups from its layer-1 plane. ``remat``
    is both MSG stages' (``TPUConfig.remat``).
    """

    def __init__(self, input_dim: int = 6, out_size: int = 256, sa_npoints=(512, 128),
                 sa_nsamples=((16, 32), (32, 64)), dtype=torch.float32, device=None, generator=None,
                 train_raw: bool = True, remat: bool = False):
        super().__init__()
        self.sa1 = SetAbstractionMSG(
            input_dim, sa_npoints[0],
            (SAScale(SA1_RADII[0], sa_nsamples[0][0], (64, 64)), SAScale(SA1_RADII[1], sa_nsamples[0][1], (64, 128))),
            dtype, device, generator, train_raw=train_raw, remat=remat,
        )
        c1 = 64 + 128
        self.sa2 = SetAbstractionMSG(
            3 + c1, sa_npoints[1],
            (SAScale(SA2_RADII[0], sa_nsamples[1][0], (128, 128)), SAScale(SA2_RADII[1], sa_nsamples[1][1], (128, 128))),
            dtype, device, generator, train_raw=False, remat=remat,
        )
        self.sa3 = SetAbstractionAll(3 + 256, (256, out_size), dtype, device, generator)

    def forward(self, pc: torch.Tensor | None, paired: bool = False, mask: torch.Tensor | None = None,
                train: bool = False, sa1_cache=None) -> torch.Tensor:
        if sa1_cache is not None:
            if paired or train:
                raise ValueError("serving SA1 caches are an unpaired eval path")
            xyz, feats = self.sa1(None, None, cache=sa1_cache)
            xyz, feats = self.sa2(xyz, feats.contiguous())
            return self.sa3(xyz, feats)
        xyz = pc[..., 0:3].float().contiguous()  # geometry stays f32
        if train:
            if paired:
                raise ValueError("the paired encoder is an eval path")
            features = pc[..., 3:] if pc.shape[-1] > 3 else None
            xyz, feats = self.sa1(xyz, features, mask=mask, train=True)
            xyz, feats = self.sa2(xyz, feats, mask=mask, train=True)
            return self.sa3(xyz, feats, mask, train=True)
        if paired:
            feats_fwd = pc[..., 3:7]
            feats_rev = torch.cat([pc[..., 3:6], pc[..., 7:8]], dim=-1)
            new_xyz, feats = self.sa1(xyz, feats_fwd, features_alt=feats_rev)  # (B, M, 2, C)
            B, M, _, C = feats.shape
            feats = feats.permute(0, 2, 1, 3).reshape(B * 2, M, C)
            xyz = new_xyz.repeat_interleave(2, dim=0)
        else:
            features = pc[..., 3:] if pc.shape[-1] > 3 else None
            xyz, feats = self.sa1(xyz, features)
        xyz, feats = self.sa2(xyz, feats.contiguous())
        return self.sa3(xyz, feats)
