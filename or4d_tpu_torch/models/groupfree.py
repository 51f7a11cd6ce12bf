"""Group-Free 3D object detection (port of ``or4d_tpu/models/groupfree.py``).

Reference: `external_src/group_free_3D/models/*` adapted to 4D-OR
(num_class=4, num_heading_bin=12, num_size_cluster=4, 20,000-point scans,
num_proposal=128):

  * backbone (backbone_module.py:12-110): PointNet++ SSG, 4 SA stages
    (2048/r.2/ns64 -> 1024/r.4/ns32 -> 512/r.8/ns16 -> 256/r1.2/ns16) with
    normalize_xyz, then 2 FP stages interpolating back to 1024 seeds, 288-d;
  * KPS sampling (modules.py:10-95, detector.py:61-67): per-seed objectness
    MLP, the top-num_proposal seeds become object candidates;
  * 6 transformer decoder layers with learned xyz position embeddings
    (detector.py:78-123, transformer.py): candidates self-attend, then
    cross-attend to all seeds; post-norm; each layer has its own PredictHead;
  * PredictHead (modules.py:98+): objectness, center residual, heading bin
    (12) + residual, size class (4) + residual against the mean sizes,
    semantic class logits.

On the card the two point ops are the port's CUDA kernels: FPS
(:func:`~or4d_tpu_torch.ops.fps.furthest_point_sample`; ``fps_cluster.cu``
for SA1's 20,000-point clouds, ``fps.cu`` for SA2-SA4) and the one-scale
index ball query
(:func:`~or4d_tpu_torch.ops.ball_query_multiscale.ball_query_multiscale`);
the rest is PyTorch. Top-k selections (KPS, 3-NN) are stable sorts, ties to
the lowest index as ``lax.top_k``. Attention is the flax
``MultiHeadDotProductAttention`` arithmetic: per-head projections, the query
scaled by 1/sqrt(head dim), softmax, dropout on the weights with one mask
broadcast over the batch and the heads, drawn from the ``generator`` passed
to :meth:`GroupFreeDetector.forward`. Parameter names follow the flax tree
(:func:`or4d_tpu_torch.convert.groupfree_from_jax_variables`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.models.layers import Dense, MaskedBatchNorm, SharedMLP
from or4d_tpu_torch.ops.ball_query_multiscale import ball_query_multiscale
from or4d_tpu_torch.ops.box_geometry import box_corners, oriented_box_iou
from or4d_tpu_torch.ops.box_geometry import nms_3d_samecls as _nms
from or4d_tpu_torch.ops.fps import furthest_point_sample
from or4d_tpu_torch.ops.interpolate import gather_rows as _gather  # reproducible backward
from or4d_tpu_torch.ops.interpolate import three_interpolate, three_nn

NUM_CLASS = 4
NUM_HEADING_BIN = 12
NUM_SIZE_CLUSTER = 4
SEED_DIM = 288
LN_EPS = 1e-6  # flax LayerNorm


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as XLA compiles a division by a constant (the JAX package's
    jitted trainer and forward): a product with 1/s, the reciprocal
    correctly rounded in x's dtype. The same bits on the card and the CPU."""
    one, d = np.ones((), torch.empty((), dtype=x.dtype).numpy().dtype), s
    return x * torch.tensor(one / one.dtype.type(d), dtype=x.dtype, device=x.device)


def mean_sizes(mean_size_arr, device) -> torch.Tensor:
    """The (num_size_cluster, 3) mean sizes, an array or a tensor, as a
    float32 tensor on ``device``."""
    if isinstance(mean_size_arr, torch.Tensor):
        return mean_size_arr.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(mean_size_arr, np.float32), device=device)


def topk_stable(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, largest first,
    ties to the lowest index (``lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class SAVotes(nn.Module):
    """PointnetSAModuleVotes (single scale, normalize_xyz=True)."""

    def __init__(self, npoint: int, radius: float, nsample: int, in_features: int, mlp, device=None, generator=None):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp = SharedMLP(3 + in_features, mlp, device=device, generator=generator)

    def forward(self, xyz, features, train: bool = False):
        idx = furthest_point_sample(xyz.contiguous(), self.npoint)
        new_xyz = _gather(xyz, idx)
        (qidx,) = ball_query_multiscale(((self.radius, self.nsample),), xyz.contiguous(), new_xyz.contiguous())
        grouped = _div(_gather(xyz, qidx) - new_xyz[:, :, None, :], self.radius)
        if features is not None:
            grouped = torch.cat([grouped, _gather(features, qidx)], dim=-1)
        h = self.mlp(grouped, train=train)
        return new_xyz, h.amax(dim=2), idx


class FPStage(nn.Module):
    """PointnetFPModule: 3-NN inverse-distance feature propagation + MLP."""

    def __init__(self, in_features: int, mlp, device=None, generator=None):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp, device=device, generator=generator)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats, train: bool = False):
        dist, idx = three_nn(unknown_xyz, known_xyz)
        # recip / sum(recip) as XLA simplifies it: (1 / x) / s -> 1 / (x * s)
        d = dist + 1e-8
        weight = 1.0 / (d * (1.0 / d).sum(dim=2, keepdim=True))
        h = three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            h = torch.cat([h, unknown_feats], dim=-1)
        return self.mlp(h, train=train)


class Backbone(nn.Module):
    """Pointnet2Backbone: 4x SA + 2x FP -> 1024 seeds, 288-d."""

    def __init__(self, in_features: int = 3, width: int = 1, device=None, generator=None):
        super().__init__()
        w = width
        kw = dict(device=device, generator=generator)
        self.sa1 = SAVotes(2048, 0.2, 64, in_features, (64 * w, 64 * w, 128 * w), **kw)
        self.sa2 = SAVotes(1024, 0.4, 32, 128 * w, (128 * w, 128 * w, 256 * w), **kw)
        self.sa3 = SAVotes(512, 0.8, 16, 256 * w, (128 * w, 128 * w, 256 * w), **kw)
        self.sa4 = SAVotes(256, 1.2, 16, 256 * w, (128 * w, 128 * w, 256 * w), **kw)
        self.fp1 = FPStage(512 * w, (256 * w, 256 * w), **kw)
        self.fp2 = FPStage(512 * w, (256 * w, SEED_DIM), **kw)

    def forward(self, pc, train: bool = False):
        xyz = pc[..., :3].float().contiguous()
        features = pc[..., 3:] if pc.shape[-1] > 3 else None
        sa1_xyz, sa1_f, sa1_idx = self.sa1(xyz, features, train)
        sa2_xyz, sa2_f, sa2_idx = self.sa2(sa1_xyz, sa1_f, train)
        sa3_xyz, sa3_f, _ = self.sa3(sa2_xyz, sa2_f, train)
        sa4_xyz, sa4_f, _ = self.sa4(sa3_xyz, sa3_f, train)
        f3 = self.fp1(sa3_xyz, sa4_xyz, sa3_f, sa4_f, train)
        f2 = self.fp2(sa2_xyz, sa3_xyz, sa2_f, f3, train)
        # seed indices into the ORIGINAL cloud (reference fp2_inds,
        # backbone_module.py:127), composed
        seed_inds = torch.gather(sa1_idx, 1, sa2_idx.long())
        return sa2_xyz, f2, seed_inds  # (B, 1024, 3), (B, 1024, 288), (B, 1024)


class PointsObjCls(nn.Module):
    """Per-seed objectness scorer (modules.py:10-38)."""

    def __init__(self, dim: int = SEED_DIM, device=None, generator=None):
        super().__init__()
        self.mlp = SharedMLP(dim, (dim, dim), device=device, generator=generator)
        self.logit = Dense(dim, 1, device=device, generator=generator)

    def forward(self, feats, train: bool = False):
        return self.logit(self.mlp(feats, train=train))[..., 0]


class PositionEmbedding(nn.Module):
    """Learned xyz position embedding (modules.py:41-57): Dense, BN (no
    mask), ReLU, Dense."""

    def __init__(self, dim: int = SEED_DIM, device=None, generator=None):
        super().__init__()
        self.fc1 = Dense(3, dim, device=device, generator=generator)
        self.bn = MaskedBatchNorm(dim, device=device)
        self.fc2 = Dense(dim, dim, device=device, generator=generator)

    def forward(self, xyz, train: bool = False):
        return self.fc2(self.bn(self.fc1(xyz), train=train, relu=True))


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (qkv_features = dim): per-head
    query/key/value projections, softmax(q k^T / sqrt(d)) in float32,
    dropout on the weights (one (1, 1, q, k) mask: ``broadcast_dropout``),
    then the output projection."""

    def __init__(self, dim: int, heads: int, dropout: float, device=None, generator=None):
        super().__init__()
        self.heads, self.d, self.rate = heads, dim // heads, dropout
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(dim, dim, device=device, generator=generator))
        self.out = Dense(dim, dim, device=device, generator=generator)

    def forward(self, q_in, k_in, v_in, train: bool = False, generator: torch.Generator | None = None):
        B, Lq, _ = q_in.shape
        Lk = k_in.shape[1]
        q = _div(self.query(q_in).reshape(B, Lq, self.heads, self.d), math.sqrt(self.d))
        k = self.key(k_in).reshape(B, Lk, self.heads, self.d)
        v = self.value(v_in).reshape(B, Lk, self.heads, self.d)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if train and self.rate > 0.0:
            keep_prob = 1.0 - self.rate
            dev = generator.device if generator is not None else w.device
            keep = torch.rand((1, 1, Lq, Lk), generator=generator, device=dev) < keep_prob
            w = w * (keep.to(w.device, w.dtype) / keep_prob)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Lq, self.heads * self.d)
        return self.out(out)


class DecoderLayer(nn.Module):
    """transformer.py TransformerDecoderLayer: self-attention over the
    candidates (query and key carry the position embedding, the value does
    not), cross-attention to the seeds, FFN; post-norm."""

    def __init__(self, dim: int = SEED_DIM, heads: int = 8, ffn: int = 2048, dropout: float = 0.1,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(dim, heads, dropout, **kw)
        self.cross_attn = MultiHeadAttention(dim, heads, dropout, **kw)
        for name in ("norm1", "norm2", "norm3"):
            self.add_module(name, nn.LayerNorm(dim, eps=LN_EPS, device=device))
        self.ffn1 = Dense(dim, ffn, **kw)
        self.ffn2 = Dense(ffn, dim, **kw)

    def forward(self, query, query_pos, key, key_pos, train: bool = False, generator=None):
        q = query + query_pos
        h = self.norm1(query + self.self_attn(q, q, query, train, generator))
        h2 = self.norm2(h + self.cross_attn(h + query_pos, key + key_pos, key, train, generator))
        f = self.ffn2(torch.relu(self.ffn1(h2)))
        return self.norm3(h2 + f)


class PredictHead(nn.Module):
    """modules.py PredictHead: the box parametrization of each candidate."""

    def __init__(self, num_class: int = NUM_CLASS, num_heading_bin: int = NUM_HEADING_BIN,
                 num_size_cluster: int = NUM_SIZE_CLUSTER, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heading_bin, self.num_size_cluster = num_heading_bin, num_size_cluster
        self.mlp = SharedMLP(SEED_DIM, (SEED_DIM, SEED_DIM), **kw)
        self.objectness = Dense(SEED_DIM, 1, **kw)
        self.center_residual = Dense(SEED_DIM, 3, **kw)
        self.heading_cls = Dense(SEED_DIM, num_heading_bin, **kw)
        self.heading_res = Dense(SEED_DIM, num_heading_bin, **kw)
        self.size_cls = Dense(SEED_DIM, num_size_cluster, **kw)
        self.size_res = Dense(SEED_DIM, num_size_cluster * 3, **kw)
        self.sem_cls = Dense(SEED_DIM, num_class, **kw)

    def forward(self, feats, base_xyz, mean_size_arr, train: bool = False) -> dict:
        h = self.mlp(feats, train=train)
        size_residual = self.size_res(h).reshape(h.shape[:-1] + (self.num_size_cluster, 3))
        return {
            "objectness": self.objectness(h)[..., 0],
            "center": base_xyz + self.center_residual(h),
            "heading_scores": self.heading_cls(h),
            "heading_residual": self.heading_res(h) * (np.pi / self.num_heading_bin),
            "size_scores": self.size_cls(h),
            "size_residual": size_residual * mean_size_arr[None, None],
            "sem_scores": self.sem_cls(h),
        }


class GroupFreeDetector(nn.Module):
    """detector.py GroupFreeDetector with KPS sampling and decoder layers.

    ``dropout`` is the decoder's attention dropout (0.1, the reference's);
    ``in_features`` the point channels after xyz (3: the dataset's centred
    colours). Built on ``device`` (the card unless given "cpu"; raises
    without one) from a CPU generator seeded with ``seed``."""

    def __init__(self, num_class: int = NUM_CLASS, num_proposal: int = 128, num_decoder_layers: int = 6,
                 width: int = 1, dropout: float = 0.1, in_features: int = 3, device=None,
                 generator: torch.Generator | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        kw = dict(device=device, generator=generator)
        self.num_proposal, self.num_decoder_layers = num_proposal, num_decoder_layers
        self.backbone = Backbone(in_features, width, **kw)
        self.points_obj_cls = PointsObjCls(**kw)
        self.proposal_head = PredictHead(num_class, **kw)
        self.decoder_query_proj = Dense(SEED_DIM, SEED_DIM, **kw)
        self.decoder_key_proj = Dense(SEED_DIM, SEED_DIM, **kw)
        for i in range(num_decoder_layers):
            self.add_module(f"self_pos_{i}", PositionEmbedding(**kw))
            self.add_module(f"cross_pos_{i}", PositionEmbedding(**kw))
            self.add_module(f"decoder_{i}", DecoderLayer(dropout=dropout, **kw))
            self.add_module(f"head_{i}", PredictHead(num_class, **kw))

    def forward(self, pc: torch.Tensor, mean_size_arr: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """``pc`` (B, N, 3 + in_features), ``mean_size_arr`` (4, 3) float32.
        Train mode normalizes with batch statistics (and updates the running
        ones) and draws the attention dropout from ``generator``."""
        seed_xyz, seed_feats, seed_inds = self.backbone(pc, train)
        obj_logits = self.points_obj_cls(seed_feats, train)
        top_idx = topk_stable(obj_logits.detach(), self.num_proposal)
        cand_xyz = _gather(seed_xyz, top_idx)
        cand_feats = _gather(seed_feats, top_idx)
        outputs = {"seeds_obj_cls_logits": obj_logits, "sample_inds": top_idx, "seed_inds": seed_inds,
                   "seed_xyz": seed_xyz}
        outputs["proposal"] = self.proposal_head(cand_feats, cand_xyz, mean_size_arr, train)

        query = self.decoder_query_proj(cand_feats)
        key = self.decoder_key_proj(seed_feats)
        base_xyz = outputs["proposal"]["center"]
        layers = []
        for i in range(self.num_decoder_layers):
            base = base_xyz.detach()
            qpos = getattr(self, f"self_pos_{i}")(base, train)
            kpos = getattr(self, f"cross_pos_{i}")(seed_xyz, train)
            query = getattr(self, f"decoder_{i}")(query, qpos, key, kpos, train, generator)
            head_out = getattr(self, f"head_{i}")(query, base, mean_size_arr, train)
            base_xyz = head_out["center"]
            layers.append(head_out)
        outputs["layers"] = layers
        outputs["last"] = layers[-1]
        return outputs


# ---------------------------------------------------------------------------
# box decoding + NMS + AP evaluation (ap_helper.py / utils/{nms,eval_det}.py)
# ---------------------------------------------------------------------------

def decode_boxes(head_out: dict, mean_size_arr):
    """Head outputs -> (center (B,K,3), size (B,K,3), heading (B,K), class,
    score) via argmax over bins/clusters (ap_helper.py box parsing)."""
    heading_cls = torch.argmax(head_out["heading_scores"], dim=-1)
    heading_res = torch.gather(head_out["heading_residual"], -1, heading_cls[..., None])[..., 0]
    heading = heading_cls.float() * float(np.float32(2 * np.pi / NUM_HEADING_BIN)) + heading_res
    heading = torch.where(heading > np.pi, heading - 2 * np.pi, heading)  # wrap to [-pi, pi]

    size_cls = torch.argmax(head_out["size_scores"], dim=-1)
    size_res = torch.gather(head_out["size_residual"], -2, size_cls[..., None, None].expand(-1, -1, 1, 3))[..., 0, :]
    size = mean_sizes(mean_size_arr, size_res.device)[size_cls] + size_res

    sem_cls = torch.argmax(head_out["sem_scores"], dim=-1)
    score = torch.sigmoid(head_out["objectness"]) * torch.softmax(head_out["sem_scores"], dim=-1).amax(-1)
    return head_out["center"], torch.clamp_min(size, 1e-3), heading, sem_cls, score


def nms_3d_samecls(centers, sizes, scores, headings=None, classes=None, iou_threshold=0.25):
    """The reference's shipped NMS (ap_helper.py:168-189, use_3d_nms +
    cls_nms): axis-aligned IoU over the AABBs of the heading-rotated corners,
    same-class suppression only. Heading/classes default to zeros."""
    centers = np.asarray(centers)
    headings = np.zeros(len(centers)) if headings is None else headings
    classes = np.zeros(len(centers), np.int64) if classes is None else classes
    return _nms(centers, sizes, headings, scores, classes, iou_threshold)


def eval_average_precision(pred_by_scan: dict, gt_by_scan: dict, iou_threshold: float = 0.25):
    """Per-class AP at an IoU threshold (utils/eval_det.py with get_iou_obb:
    ORIENTED 3D IoU over heading-rotated corners, VOC-style AP).

    ``pred_by_scan``: {scan: [(cls, center, size, heading, score), ...]};
    ``gt_by_scan``: {scan: [(cls, center, size, heading), ...]}.
    """
    classes = sorted({c for preds in pred_by_scan.values() for (c, *_rest) in preds}
                     | {c for gts in gt_by_scan.values() for (c, *_r) in gts})
    aps = {}
    for cls in classes:
        records = []  # (score, is_tp)
        n_gt = 0
        for scan, gts in gt_by_scan.items():
            cls_gts = [g for g in gts if g[0] == cls]
            n_gt += len(cls_gts)
            gt_corners = [box_corners(np.asarray(gc), np.asarray(gs), gh) for (_, gc, gs, gh) in cls_gts]
            used = np.zeros(len(cls_gts), bool)
            preds = sorted([p for p in pred_by_scan.get(scan, []) if p[0] == cls], key=lambda p: -p[4])
            for _, center, size, heading, score in preds:
                pc = box_corners(np.asarray(center), np.asarray(size), heading)
                best_iou, best_j = 0.0, -1
                for j, gc in enumerate(gt_corners):
                    iou, _ = oriented_box_iou(pc, gc)
                    if iou > best_iou:
                        best_iou, best_j = iou, j
                tp = best_iou >= iou_threshold and best_j >= 0 and not used[best_j]
                if tp:
                    used[best_j] = True
                records.append((score, tp))
        if n_gt == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.cumsum([r[1] for r in records]) if records else np.array([])
        fps = np.cumsum([not r[1] for r in records]) if records else np.array([])
        recall = tps / n_gt if len(tps) else np.array([0.0])
        precision = tps / np.maximum(tps + fps, 1e-9) if len(tps) else np.array([0.0])
        # VOC-style interpolated AP
        mrec = np.concatenate([[0.0], recall, [1.0]])
        mpre = np.concatenate([[0.0], precision, [0.0]])
        for k in range(len(mpre) - 2, -1, -1):
            mpre[k] = max(mpre[k], mpre[k + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        aps[cls] = float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    return aps
