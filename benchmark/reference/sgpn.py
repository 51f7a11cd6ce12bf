"""SGPN, plain: the published PointNet++ MSG encoders, the TripletGCN and
the heads (4D-OR ``scene_graph_prediction_model.py``, ``pointnet2_msg_cls.py``,
``network_TripletGCN.py``, ``network_PointNet.py``), forward in eval and
train mode, and the weighted NLL loss.

Parameters come as a dict name -> tensor; the names are the state_dict
names the benchmark loads into the program (``param_specs`` lists them
with their shapes and how the benchmark draws them). The encoders run on
the valid object and edge slots only, every directed edge on its own crop,
and their features are scattered into the padded (S, O) / (S, E) layout the
GCN takes. Eval BN normalises with the stored statistics, train BN with
the batch moments over every valid row (the GCN's always with the masked
batch moments). A grouped MLP runs in blocks of clouds in eval, and over
all rows under activation checkpointing in train.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from reference.geometry import ball_query, fps, gather_points
from reference.precision import Precision

BN_EPS = 1e-5
DROPOUT = 0.3
_BLOCK_ELEMS = 1 << 27  # grouped elements (clouds x M x ns x widest channel) an eval block holds


# ---------------------------------------------------------------------------
# the parameter table
# ---------------------------------------------------------------------------

def _stages(cfg: dict):
    """The config's SA1, SA2 and SA3 blocks (``pointnet2_msg``)."""
    pn = cfg["pointnet2_msg"]
    return pn["sa1"], pn["sa2"], pn["sa3"]


def encoder_specs(prefix: str, c0: int, cfg: dict):
    sa1, sa2, sa3 = _stages(cfg)
    out = []

    def mlp(pre, cin, widths):
        for i, w in enumerate(widths):
            out.append((f"{pre}.dense_{i}.weight", (w, cin), "dense", cin))
            out.extend((f"{pre}.bn_{i}.{k}", (w,), f"bn_{k}", 0) for k in
                       ("weight", "bias", "running_mean", "running_var"))
            cin = w

    for si, widths in enumerate(sa1["mlps"]):
        mlp(f"{prefix}.sa1.mlp_{si}", c0, widths)
    c1 = sum(w[-1] for w in sa1["mlps"])
    for si, widths in enumerate(sa2["mlps"]):
        mlp(f"{prefix}.sa2.mlp_{si}", 3 + c1, widths)
    c2 = sum(w[-1] for w in sa2["mlps"])
    mlp(f"{prefix}.sa3.mlp", 3 + c2, sa3["mlp"])
    return out


def param_specs(cfg: dict):
    """[(name, shape, kind, fan_in)] of every SGPN tensor (without the image
    branch: ``reference.efficientnet.param_specs``)."""
    m = cfg["MODEL"]
    D, De, H = m["point_feature_size"], m["edge_feature_size"], m["gcn_hidden_feature_size"]
    out = encoder_specs("obj_encoder", 6, cfg) + encoder_specs("rel_encoder", 7, cfg)

    def dense(pre, i, o, kind="dense"):
        out.append((f"{pre}.weight", (o, i), kind, i if kind == "dense" else (i + o) / 2.0))
        out.append((f"{pre}.bias", (o,), "bias", 0))

    for layer in range(m["N_LAYERS"]):
        pre = f"gcn.layer_{layer}"
        dense(f"{pre}.nn1.dense_0", 2 * D + De, H)
        out.extend((f"{pre}.nn1.bn_0.{k}", (H,), f"bn_{k}", 0) for k in ("weight", "bias"))
        dense(f"{pre}.nn1.dense_1", H, 2 * H + De)
        out.extend((f"{pre}.nn1.bn_1.{k}", (2 * H + De,), f"bn_{k}", 0) for k in ("weight", "bias"))
        dense(f"{pre}.nn2.dense_0", H, H)
        out.extend((f"{pre}.nn2.bn_0.{k}", (H,), f"bn_{k}", 0) for k in ("weight", "bias"))
        dense(f"{pre}.nn2.dense_1", H, D)
    C, R = cfg["classes"], cfg["relations"]
    dense("obj_predictor.fc1", D, 512, "xavier")
    dense("obj_predictor.fc2", 512, 256, "xavier")
    dense("obj_predictor.fc3", 256, C, "xavier")
    img = m["FULL_IMAGE_EMBEDDING_SIZE"] if cfg.get("IMAGE_INPUT") == "full" else 0
    dense("rel_predictor.fc1", De, 512, "xavier")
    dense("rel_predictor.fc2", 512, 256, "xavier")
    dense("rel_predictor.fc3", 256 + img + 2 * cfg["object_types"], R, "xavier")
    return out


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------

def _bn(P, pre, h, train: bool):
    if train:
        flat = h.reshape(-1, h.shape[-1])
        mean = flat.mean(0)
        var = ((flat - mean) ** 2).mean(0)
    else:
        mean, var = P[f"{pre}.running_mean"], P[f"{pre}.running_var"]
    return (h - mean) * torch.rsqrt(var + BN_EPS) * P[f"{pre}.weight"] + P[f"{pre}.bias"]


def _shared_mlp(P, pre, h, n: int, train: bool, prec: Precision):
    for i in range(n):
        h = torch.relu(_bn(P, f"{pre}.bn_{i}", prec.linear(h, P[f"{pre}.dense_{i}.weight"]), train))
    return h


def _grouped(P, pre, xyz, new_xyz, feats, gidx, n, train, prec):
    """max over the slots of the MLP on [p - q, f_p] of every grouped slot."""
    g = gather_points(xyz, gidx) - new_xyz[:, :, None, :]
    if feats is not None:
        g = torch.cat([g, gather_points(feats, gidx)], dim=-1)
    return _shared_mlp(P, pre, g, n, train, prec).amax(dim=2)


def _sa_msg(P, pre, xyz, feats, stage, train: bool, prec: Precision):
    idx = fps(xyz, stage["npoint"])
    new_xyz = gather_points(xyz, idx)
    outs = []
    for si, (r, ns, widths) in enumerate(zip(stage["radii"], stage["nsamples"], stage["mlps"])):
        gidx = ball_query(xyz, new_xyz, r, ns)
        spre = f"{pre}.mlp_{si}"
        if train:
            fn = lambda f, gidx=gidx, spre=spre, n=len(widths): _grouped(P, spre, xyz, new_xyz, f, gidx, n, True, prec)
            outs.append(checkpoint(fn, feats, use_reentrant=False))
            continue
        B, M = gidx.shape[:2]
        widest = max([xyz.shape[-1] + (0 if feats is None else feats.shape[-1])] + list(widths))
        step = max(1, _BLOCK_ELEMS // (M * ns * widest))
        outs.append(torch.cat([
            _grouped(P, spre, xyz[b:b + step], new_xyz[b:b + step], None if feats is None else feats[b:b + step],
                     gidx[b:b + step], len(widths), False, prec)
            for b in range(0, B, step)]))
    return new_xyz, torch.cat(outs, dim=-1)


def encoder(P, prefix: str, pc: torch.Tensor, cfg: dict, train: bool = False, prec: Precision | None = None):
    """(R, P, C) crops (xyz, then features) -> (R, out) global features."""
    prec = prec or Precision()
    sa1, sa2, sa3 = _stages(cfg)
    xyz = pc[..., :3].float().contiguous()
    feats = pc[..., 3:].float() if pc.shape[-1] > 3 else None
    xyz, feats = _sa_msg(P, f"{prefix}.sa1", xyz, feats, sa1, train, prec)
    xyz, feats = _sa_msg(P, f"{prefix}.sa2", xyz, feats, sa2, train, prec)
    x = torch.cat([xyz, feats], dim=-1)
    if train:
        return _shared_mlp(P, f"{prefix}.sa3.mlp", x, len(sa3["mlp"]), True, prec).amax(dim=1)
    step = max(1, _BLOCK_ELEMS // (x.shape[1] * max(x.shape[-1], *sa3["mlp"])))
    return torch.cat([_shared_mlp(P, f"{prefix}.sa3.mlp", x[b:b + step], len(sa3["mlp"]), False, prec).amax(dim=1)
                      for b in range(0, x.shape[0], step)])


# ---------------------------------------------------------------------------
# GCN and heads
# ---------------------------------------------------------------------------

def _masked_bn(P, pre, x, mask):
    C = x.shape[-1]
    m = torch.broadcast_to(mask.float(), x.shape[:-1]).reshape(-1, 1)
    xf = x.reshape(-1, C)
    count = torch.clamp(m.sum(), min=1.0)
    mean = (xf * m).sum(0) / count
    var = (((xf - mean) ** 2) * m).sum(0) / count
    return (x - mean) * torch.rsqrt(var + BN_EPS) * P[f"{pre}.weight"] + P[f"{pre}.bias"]


def _gcn_mlp(P, pre, x, mask, n: int, on_last: bool, prec):
    for i in range(n):
        x = prec.linear(x, P[f"{pre}.dense_{i}.weight"], P[f"{pre}.dense_{i}.bias"])
        if i < n - 1 or on_last:
            x = torch.relu(_masked_bn(P, f"{pre}.bn_{i}", x, mask))
    return x


def gcn(P, cfg, x, e, edge_index, obj_mask, edge_mask, prec):
    H = cfg["MODEL"]["gcn_hidden_feature_size"]
    De = e.shape[-1]
    L = cfg["MODEL"]["N_LAYERS"]
    src = edge_index[..., 0].long()
    dst = edge_index[..., 1].long()
    take = lambda t, i: torch.gather(t, 1, i[..., None].expand(-1, -1, t.shape[-1]))
    for layer in range(L):
        pre = f"gcn.layer_{layer}"
        h = _gcn_mlp(P, f"{pre}.nn1", torch.cat([take(x, dst), e, take(x, src)], dim=-1), edge_mask, 2, True, prec)
        dx_i, new_e, dx_j = h[..., :H], h[..., H:H + De], h[..., H + De:]
        msg = (dx_i + dx_j) * edge_mask[..., None].float()
        agg = torch.zeros(x.shape[0], x.shape[1], H, device=x.device)
        agg = agg.scatter_add(1, dst[..., None].expand(-1, -1, H), msg)
        x = _gcn_mlp(P, f"{pre}.nn2", agg, obj_mask, 2, False, prec)
        e = new_e
        if layer < L - 1:
            x, e = torch.relu(x), torch.relu(e)
    return x, e


def _trunk(P, pre, x, keep, prec):
    x = prec.linear(torch.relu(prec.linear(x, P[f"{pre}.fc1.weight"], P[f"{pre}.fc1.bias"])),
                    P[f"{pre}.fc2.weight"], P[f"{pre}.fc2.bias"])
    if keep is not None:
        x = torch.where(keep, x / (1.0 - DROPOUT), torch.zeros((), device=x.device))
    return torch.relu(x)


def heads(P, gcn_obj, gcn_rel, rel_onehot, keep: dict | None, image_emb, prec):
    keep = keep or {}
    obj = prec.linear(_trunk(P, "obj_predictor", gcn_obj, keep.get("obj"), prec),
                      P["obj_predictor.fc3.weight"], P["obj_predictor.fc3.bias"])
    parts = [_trunk(P, "rel_predictor", gcn_rel, keep.get("rel"), prec)]
    if image_emb is not None:
        parts.append(image_emb[:, None, :].expand(-1, gcn_rel.shape[1], -1))
    parts.append(rel_onehot.float())
    rel = prec.linear(torch.cat(parts, dim=-1), P["rel_predictor.fc3.weight"], P["rel_predictor.fc3.bias"])
    return torch.log_softmax(obj, dim=-1), torch.log_softmax(rel, dim=-1)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def features(P, cfg, batch: dict, train: bool, prec: Precision):
    """Both encoders on the valid slots, scattered into (S, O, D), (S, E, De)."""
    S, O = batch["obj_mask"].shape
    E = batch["edge_mask"].shape[1]
    om = batch["obj_mask"].reshape(-1).bool()
    em = batch["edge_mask"].reshape(-1).bool()
    obj_pc = batch["obj_points"].reshape((S * O,) + tuple(batch["obj_points"].shape[2:]))[om]
    rel_pc = batch["rel_points"].reshape((S * E,) + tuple(batch["rel_points"].shape[2:]))[em]
    fo = encoder(P, "obj_encoder", obj_pc, cfg, train, prec)
    fr = encoder(P, "rel_encoder", rel_pc, cfg, train, prec)
    obj_feat = torch.zeros(S * O, fo.shape[-1], device=fo.device).index_put((om.nonzero()[:, 0],), fo)
    rel_feat = torch.zeros(S * E, fr.shape[-1], device=fr.device).index_put((em.nonzero()[:, 0],), fr)
    return obj_feat.reshape(S, O, -1), rel_feat.reshape(S, E, -1)


def from_features(P, cfg, batch, obj_feat, rel_feat, prec, keep=None, image_emb=None):
    x, e = gcn(P, cfg, obj_feat, rel_feat, batch["edge_index"], batch["obj_mask"], batch["edge_mask"], prec)
    return heads(P, x, e, batch["rel_onehot"], keep, image_emb, prec)


def forward(P, cfg, batch: dict, train: bool = False, keep=None, image_emb=None, prec: Precision | None = None):
    """(obj_logprobs (S, O, C), rel_logprobs (S, E, R))."""
    prec = prec or Precision()
    obj_feat, rel_feat = features(P, cfg, batch, train, prec)
    return from_features(P, cfg, batch, obj_feat, rel_feat, prec, keep, image_emb)


def weighted_nll(logprobs, targets, weights, mask):
    targets = targets.long()
    picked = torch.gather(logprobs, -1, targets[..., None])[..., 0]
    w = weights[targets] * mask.float()
    return -(picked * w).sum() / torch.clamp(w.sum(), min=1e-12)


def loss(cfg, obj_lp, rel_lp, batch, w_obj, w_rel):
    lo = weighted_nll(obj_lp, batch["gt_class"], w_obj, batch["obj_mask"])
    lr = weighted_nll(rel_lp, batch["gt_rels"], w_rel, batch["edge_mask"])
    return cfg["MODEL"]["lambda_o"] * lo + lr
