"""SGPN — the scene-graph prediction model and its loss (port of
``or4d_tpu/models/sgpn.py``).

Reference ``scene_graph_prediction_model.py:30-109``: PointNet++ MSG object
encoder on (O, 4000, 6) crops and relation encoder on (E, 8000, 7) union
crops -> 256-d each; TripletGCN (2 layers, hidden 512) over the fully
connected scene graph; object head on GCN node features and relation head on
GCN edge features with subject/object one-hot late fusion; the
multimodal model (``no_gt_image``) fuses a 768-d scene embedding from a
frozen EfficientNet-B5 over the six cameras into the relation head
(:mod:`or4d_tpu_torch.models.efficientnet`), and MULTI_REL_OUTPUTS makes
that head a sigmoid multi-label one trained with :func:`weighted_bce`.

The model consumes a whole :class:`SceneBatch` (scenes stacked, objects and
edges padded). A :class:`SlotPack` runs the encoders over the valid rows
only and scatters the features back; a paired pack (pair-shared crops) runs
the relation encoder once per unordered pair and scatters both directions
(eval only: training encodes every directed edge). Serving mode hands the
encoders SA1 caches built for the batch's flat pack
(:mod:`or4d_tpu_torch.serving`); the raw crops are then never read.

``forward`` builds no autograd graph only under ``torch.no_grad()``, which
the eval entry points (``infer.predict_relations``, ``Trainer.eval_step``)
take.

On a mesh of ranks (:meth:`SGPN.set_mesh`) a rank runs its dp block of
scenes; the BN moments and the loss denominators are taken over every
rank's rows. On an mp > 1 mesh a rank's encoders run its block of the
object and edge slots (no pack), and their features are gathered over the
mp group before the TripletGCN, which needs every slot of a scene; the GCN
and the heads then run on each mp rank alike.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from or4d_tpu_torch.config import ExperimentConfig
from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
from or4d_tpu_torch.device import resolve_device
from or4d_tpu_torch.models.heads import ObjectClsHead, RelationClsHead
from or4d_tpu_torch.models.layers import MaskedBatchNorm
from or4d_tpu_torch.models.pointnet2 import PointNet2MSGEncoder
from or4d_tpu_torch.models.triplet_gcn import TripletGCN
from or4d_tpu_torch.parallel.mesh import all_reduce_, gather, slot_block


@dataclasses.dataclass
class SGPNOutputs:
    obj_logprobs: torch.Tensor  # (S, O, num_classes) float32
    rel_logprobs: torch.Tensor  # (S, E, num_relations) float32; probabilities with multi_rel_outputs
    obj_features: torch.Tensor  # (S, O, D)
    rel_features: torch.Tensor  # (S, E, D)


class SGPN(nn.Module):
    """Parameters are made on the CPU from ``generator`` (seeded by ``seed``
    when none is given) and moved to ``device`` (default ``cuda``; raises
    without a card unless ``device="cpu"``). ``train_raw`` picks both
    encoders' SA1 train grouping (``TPUConfig.train_raw``; see
    :mod:`or4d_tpu_torch.models.pointnet2`). ``use_image`` adds the image
    branch (``batch.images`` (S, 6, H, W, 3) then feeds the relation head);
    ``multi_rel_outputs`` makes the relation head sigmoid multi-label."""

    def __init__(self, num_classes: int = 12, num_relations: int = 15, point_feature_size: int = 256,
                 edge_feature_size: int = 256, gcn_hidden: int = 512, gcn_layers: int = 2,
                 obj_pred_from_gcn: bool = True, compute_dtype=torch.float32, sa_npoints=(512, 128),
                 sa_nsamples=((16, 32), (32, 64)), device=None, generator: torch.Generator | None = None, seed: int = 0,
                 train_raw: bool = True, remat: bool = False, use_image: bool = False,
                 image_embedding_size: int = 768, multi_rel_outputs: bool = False):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.compute_dtype = compute_dtype
        self.point_feature_size = point_feature_size
        self.edge_feature_size = edge_feature_size
        self.obj_pred_from_gcn = obj_pred_from_gcn
        enc = dict(sa_npoints=tuple(sa_npoints), sa_nsamples=tuple(tuple(s) for s in sa_nsamples),
                   dtype=compute_dtype, device=device, generator=generator, train_raw=train_raw, remat=remat)
        # xyz + rgb object crops; xyz + rgb + subject/object mask relation crops
        self.obj_encoder = PointNet2MSGEncoder(6, point_feature_size, **enc)
        self.rel_encoder = PointNet2MSGEncoder(7, edge_feature_size, **enc)
        self.gcn = TripletGCN(gcn_layers, point_feature_size, edge_feature_size, gcn_hidden, device, generator)
        self.obj_predictor = ObjectClsHead(point_feature_size, num_classes, device, generator)
        self.use_image = use_image
        self.multi_rel_outputs = multi_rel_outputs
        self.rel_predictor = RelationClsHead(edge_feature_size, num_relations,
                                             image_features=image_embedding_size if use_image else 0,
                                             multi_label=multi_rel_outputs, device=device, generator=generator)
        if use_image:
            from or4d_tpu_torch.models.efficientnet import ImageBranch

            self.image_branch = ImageBranch(image_embedding_size, device=device, generator=generator)
        self.mesh = None

    def set_mesh(self, mesh) -> None:
        """Run as one rank of ``mesh`` (:class:`~or4d_tpu_torch.parallel.Mesh`):
        the encoders' BN reduces over every rank (each holds its own rows),
        the GCN's over the dp group (the mp ranks of a dp index hold the same
        scenes' slots after the gather)."""
        self.mesh = mesh
        for name, m in self.named_modules():
            if isinstance(m, MaskedBatchNorm):
                m.group = mesh.dp_group if name.startswith("gcn.") else mesh.world

    @classmethod
    def from_config(cls, cfg: ExperimentConfig, num_classes: int, num_relations: int, **kw) -> "SGPN":
        return cls(
            num_classes=num_classes,
            num_relations=num_relations,
            point_feature_size=cfg.model.point_feature_size,
            edge_feature_size=cfg.model.edge_feature_size,
            gcn_hidden=cfg.model.gcn_hidden_feature_size,
            gcn_layers=cfg.model.n_layers,
            obj_pred_from_gcn=cfg.model.obj_pred_from_gcn,
            compute_dtype=torch.bfloat16 if cfg.tpu.compute_dtype == "bfloat16" else torch.float32,
            sa_npoints=tuple(cfg.model.sa_npoints),
            sa_nsamples=tuple(tuple(s) for s in cfg.model.sa_nsamples),
            train_raw=cfg.tpu.train_raw,
            remat=cfg.tpu.remat,
            use_image=cfg.image_input == "full",
            image_embedding_size=cfg.model.full_image_embedding_size,
            multi_rel_outputs=cfg.model.multi_rel_outputs,
            **kw,
        )

    @property
    def device(self) -> torch.device:
        return self.gcn.layer_0.nn1.dense_0.weight.device

    def forward(self, batch: SceneBatch, pack: SlotPack | None = None, train: bool = False,
                dropout_keep: dict | None = None, sa1_caches=None) -> SGPNOutputs:
        """``batch`` and ``pack`` hold tensors on the model's device.
        ``batch`` may hold only the crop rows that ``pack`` reads, in its
        order (``SceneBatch.to(device, pack=host_plan)``: (Co, Po, 6) and
        (Cp or Ce, Pr, 7) crops beside (S, O) and (S, E) masks); the eval
        forward then reads them as they are, the same rows as it would
        gather from the padded crops.

        ``train=True``: batch statistics over the valid rows (pack validity,
        or the batch masks without a pack), running statistics updated, and
        head dropout with keep-masks ``dropout_keep`` {"obj": (S, O, 256),
        "rel": (S, E, 256)} (required; the trainer draws them for the global
        batch).

        ``sa1_caches``: (obj_cache, rel_cache) serving SA1 geometry built
        for this batch and its flat pack (``serving.build_sgpn_sa1_caches``);
        the crops are not read. Eval only, unpaired packs only."""
        if sa1_caches is not None:
            if train or (pack is not None and pack.paired):
                raise ValueError("sa1_caches: eval-only, unpaired packs")
            obj_feat = self.obj_encoder(None, sa1_cache=sa1_caches[0])
            rel_feat = self.rel_encoder(None, sa1_cache=sa1_caches[1])
            return self._head(batch, pack, obj_feat, rel_feat, False, False, None)
        mesh = self.mesh
        slots = batch
        if mesh is not None and mesh.mp > 1:
            if pack is not None:
                raise ValueError("slot packing is dp-only: an mp > 1 mesh runs without a pack")
            slots = dataclasses.replace(batch, **{f: slot_block(getattr(batch, f), mesh) for f in
                                                  ("obj_points", "rel_points", "obj_mask", "edge_mask")})
        S, O = slots.obj_mask.shape
        E = slots.edge_mask.shape[1]
        obj_rows = slots.obj_mask.reshape(S * O).float()
        edge_rows = slots.edge_mask.reshape(S * E).float()
        paired = not train and pack is not None and pack.paired
        rel_idx = None if pack is None else pack.pair_idx if paired else pack.edge_idx
        if slots.obj_points.dim() == 3:  # the crop rows of ``pack``, in its order (SceneBatch.to(pack=...))
            if (train or pack is None or slots.obj_points.shape[0] != pack.obj_idx.shape[0]
                    or slots.rel_points.shape[0] != rel_idx.shape[0]):
                raise ValueError("crops uploaded in pack order need that pack, in eval")
            obj_flat = slots.obj_points.float()
            rel_flat = slots.rel_points.float()
        else:
            obj_flat = slots.obj_points.flatten(0, 1).float()
            rel_flat = slots.rel_points.flatten(0, 1).float()
            if pack is not None:
                obj_flat = obj_flat[pack.obj_idx]
                rel_flat = rel_flat[rel_idx]
        if pack is not None:
            obj_rows = pack.obj_valid.float()
            edge_rows = pack.pair_valid.float() if paired else pack.edge_valid.float()
        if paired:
            # forward crops -> both mask channels (1 <-> 2 swapped for the reverse)
            m = rel_flat[..., 6:7]
            rel_flat = torch.cat([rel_flat[..., :6], m, torch.where(m > 0, 3.0 - m, torch.zeros_like(m))], dim=-1)

        obj_feat = self.obj_encoder(obj_flat, mask=obj_rows, train=train)
        rel_feat = self.rel_encoder(rel_flat, paired=paired, mask=edge_rows, train=train)
        if slots is not batch:  # every slot of the block's scenes, in slot order
            obj_feat = gather(obj_feat.reshape(S, O, -1), mesh.mp_group, dim=1).flatten(0, 1)
            rel_feat = gather(rel_feat.reshape(S, E, -1), mesh.mp_group, dim=1).flatten(0, 1)
        return self._head(batch, pack, obj_feat, rel_feat, paired, train, dropout_keep)

    def _head(self, batch, pack, obj_feat, rel_feat, paired, train, dropout_keep) -> SGPNOutputs:
        """Encoder rows scattered back into the padded layout, then the GCN
        and the heads."""
        S, O = batch.obj_mask.shape
        E = batch.edge_mask.shape[1]
        D, De = self.point_feature_size, self.edge_feature_size
        if pack is not None:
            ov = pack.obj_valid[:, None].to(obj_feat.dtype)
            obj_feat = obj_feat.new_zeros(S * O, D).index_add_(0, pack.obj_idx, obj_feat * ov)
            if paired:
                pv = pack.pair_valid[:, None].to(rel_feat.dtype)
                rel_feat = (rel_feat.new_zeros(S * E, De)
                            .index_add_(0, pack.pair_idx, rel_feat[0::2] * pv)
                            .index_add_(0, pack.pair_rev_idx, rel_feat[1::2] * pv))
            else:
                ev = pack.edge_valid[:, None].to(rel_feat.dtype)
                rel_feat = rel_feat.new_zeros(S * E, De).index_add_(0, pack.edge_idx, rel_feat * ev)
        obj_feat = obj_feat.reshape(S, O, D)
        rel_feat = rel_feat.reshape(S, E, De)

        gcn_obj, gcn_rel = self.gcn(obj_feat, rel_feat, batch.edge_index, batch.obj_mask, batch.edge_mask)
        if train and dropout_keep is None:
            raise ValueError("train mode needs dropout_keep: the trainer draws it for the global batch")
        keep = dropout_keep or {}
        obj_logprobs = self.obj_predictor(gcn_obj if self.obj_pred_from_gcn else obj_feat, train, keep.get("obj"))
        image_embeddings = self.image_branch(batch.images) if self.use_image else None
        rel_logprobs = self.rel_predictor(gcn_rel, batch.rel_onehot, train, keep.get("rel"), image_embeddings)
        return SGPNOutputs(
            obj_logprobs=obj_logprobs.float(),
            rel_logprobs=rel_logprobs.float(),
            obj_features=obj_feat,
            rel_features=rel_feat,
        )


def weighted_nll(logprobs: torch.Tensor, targets: torch.Tensor, class_weights: torch.Tensor,
                 mask: torch.Tensor, group=None) -> torch.Tensor:
    """torch ``F.nll_loss(weight=w)`` with validity masking: weighted mean of
    -logprob[target] with weights w[target] * mask (reference training_step
    :134-145). ``group``: the weights' sum is taken over its ranks' batches
    too, so the ranks' terms add up to the global batch's loss."""
    targets = targets.long()
    picked = torch.gather(logprobs, -1, targets[..., None])[..., 0]
    w = class_weights[targets] * mask.to(logprobs.dtype)
    return -(picked * w).sum() / torch.clamp(all_reduce_(w.sum(), group), min=1e-12)


def weighted_bce(probs: torch.Tensor, targets: torch.Tensor, class_weights: torch.Tensor,
                 mask: torch.Tensor, group=None) -> torch.Tensor:
    """MULTI_REL_OUTPUTS loss: torch ``F.binary_cross_entropy(weight=w)``
    over (S, E, R) sigmoid probabilities and multi-hot targets, per element
    w[c] * BCE, averaged over the valid edges' elements (over ``group``'s
    batches too, as :func:`weighted_nll`); probabilities clipped to
    [1e-7, 1 - 1e-7] (or4d_tpu/models/sgpn.py:271-282)."""
    p = torch.clamp(probs.float(), 1e-7, 1.0 - 1e-7)
    y = targets.float()
    bce = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p)) * class_weights
    m = mask.float()[..., None]
    return (bce * m).sum() / torch.clamp(all_reduce_(m.sum(), group) * probs.shape[-1], min=1e-12)


def sgpn_loss(outputs: SGPNOutputs, batch: SceneBatch, weights_obj: torch.Tensor, weights_rel: torch.Tensor,
              lambda_o: float = 1e-6, group=None):
    """(loss, {"loss_obj", "loss_rel", "loss"}): loss = lambda_o * obj NLL +
    rel NLL (reference :139-141); the relation term is :func:`weighted_bce`
    where ``gt_rels`` is a multi-hot (S, E, R) (MULTI_REL_OUTPUTS).
    ``group``: this rank's share of the loss of its ranks' batches
    together (the shares sum to it)."""
    loss_obj = weighted_nll(outputs.obj_logprobs, batch.gt_class, weights_obj, batch.obj_mask, group)
    if batch.gt_rels.dim() == outputs.rel_logprobs.dim():
        loss_rel = weighted_bce(outputs.rel_logprobs, batch.gt_rels, weights_rel, batch.edge_mask, group)
    else:
        loss_rel = weighted_nll(outputs.rel_logprobs, batch.gt_rels, weights_rel, batch.edge_mask, group)
    loss = lambda_o * loss_obj + loss_rel
    return loss, {"loss_obj": loss_obj, "loss_rel": loss_rel, "loss": loss}
