"""The SGPN train step, plain: the training augmentation, head dropout, the
weighted NLL loss, autograd and AdamW (lr, weight decay, betas 0.9/0.999,
eps 1e-8, every trainable tensor decayed), as the 4D-OR ``training_step``
with ``torch.optim.AdamW`` runs it.

The augmentation (4D-OR ``augmentation_utils.py``; applied to a scene with
probability 0.75) is a frozen copy of the element-wise formulation the
program uses, and its draws come from a CPU ``torch.Generator`` in the same
order (the scene flags, the object crops' draws, the hand thresholds, the
relation crops' three draws, then the object and relation dropout masks),
so a generator seeded alike gives the same numbers: the reference works the
draws out again from the seed instead of reading the program's.
"""

from __future__ import annotations

import math

import torch

from reference import sgpn
from reference.precision import Precision

OBJ_CFG = {"brightness": 0.1, "colors": 0.05, "x_rot": 20.0, "y_rot": 45.0, "z_rot": 20.0, "shift": 0.15,
           "scale": (0.4, 1.6)}
REL_CFG = {"brightness": 0.1, "colors": 0.025, "x_rot": 10.0, "y_rot": 20.0, "z_rot": 10.0, "shift": 0.1,
           "scale": (0.4, 1.6)}
HAND_THRESHOLD = 0.2
APPLY_P = 0.75
_CROP_DRAWS = (("brightness", ()), ("colors", (3,)), ("shift", (3,)), ("y_rot", ()), ("x_rot", ()), ("z_rot", ()),
               ("scale", ()))
BETAS, EPS = (0.9, 0.999), 1e-8


def _range(cfg, k):
    return cfg["scale"] if k == "scale" else (-cfg[k], cfg[k])


def _crop_draws(lead, cfg, gen):
    out = {}
    for k, tail in _CROP_DRAWS:
        lo, hi = _range(cfg, k)
        out[k] = torch.rand(tuple(lead) + tail, generator=gen) * (hi - lo) + lo
    return out


def draw_step(S: int, O: int, E: int, gen: torch.Generator, augment: bool, hidden: int = 256) -> dict:
    """One step's random draws, in the order the step takes them."""
    d = {}
    if augment:
        d["apply"] = torch.rand(S, generator=gen) < APPLY_P
        d["obj"] = _crop_draws((S, O), OBJ_CFG, gen)
        d["thres"] = torch.rand((S, E), generator=gen) * (1.0 - HAND_THRESHOLD) + HAND_THRESHOLD
        d["rel"] = (_crop_draws((S, E), OBJ_CFG, gen), _crop_draws((S, E), REL_CFG, gen),
                    _crop_draws((S, E), REL_CFG, gen))
    d["keep"] = {"obj": torch.rand((S, O, hidden), generator=gen) < 1.0 - sgpn.DROPOUT,
                 "rel": torch.rand((S, E, hidden), generator=gen) < 1.0 - sgpn.DROPOUT}
    return d


def _rot(deg, axis):
    r = deg * (math.pi / 180.0)
    c, s = torch.cos(r), torch.sin(r)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = [[c, z, s], [z, o, z], [-s, z, c]] if axis == "y" else [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _sum_points(x):
    P = x.shape[-2]
    n = 1 << (P - 1).bit_length()
    if n != P:
        x = torch.nn.functional.pad(x, (0, 0, 0, n - P))
    while x.shape[-2] > 1:
        h = x.shape[-2] // 2
        x = x[..., :h, :] + x[..., h:, :]
    return x[..., 0, :]


def _right_mul(p, R):
    t = p[..., :, :, None] * R[..., None, :, :]
    return t[..., 0, :] + t[..., 1, :] + t[..., 2, :]


def augment_crops(points, d, subset=None):
    xyz, rgb = points[..., :3], points[..., 3:6]
    m = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device) if subset is None else subset
    mf = m[..., None].to(points.dtype)
    rgb_new = torch.clamp((rgb + d["brightness"][..., None, None]) + d["colors"][..., None, :], 0.0, 1.0)
    xyz_new = xyz + d["shift"][..., None, :]
    count = torch.clamp(_sum_points(mf), min=1.0)
    center = _sum_points(xyz_new * mf) / count
    rotated = xyz_new - center[..., None, :]
    for deg, axis in ((d["y_rot"], "y"), (d["x_rot"], "y"), (d["z_rot"], "z")):
        rotated = _right_mul(rotated, _rot(deg, axis))
    xyz_new = rotated * d["scale"][..., None, None] + center[..., None, :]
    return torch.cat([torch.where(m[..., None], xyz_new, xyz), torch.where(m[..., None], rgb_new, rgb),
                      points[..., 6:]], dim=-1)


def augment_batch(batch: dict, d: dict, contact_ids) -> dict:
    """The batch with augmented object and relation crops (draws ``d`` on
    the batch's device)."""
    rel = batch["rel_points"]
    diff = rel[..., :, None, :3] - batch["rel_hand_points"][..., None, :, :]
    sq = diff * diff
    dist = torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2]).amin(-1)
    contact = torch.isin(batch["gt_rels"], torch.tensor(contact_ids, device=rel.device))
    zero = contact[..., None] & (dist > d["thres"][..., None])
    rel = torch.where(zero[..., None], torch.zeros((), dtype=rel.dtype, device=rel.device), rel)
    rel = augment_crops(rel, d["rel"][0])
    rel = augment_crops(rel, d["rel"][1], rel[..., 6] == 1)
    rel = augment_crops(rel, d["rel"][2], rel[..., 6] == 2)
    obj = augment_crops(batch["obj_points"], d["obj"])
    sel = d["apply"][:, None, None, None]
    return {**batch, "obj_points": torch.where(sel, obj, batch["obj_points"]),
            "rel_points": torch.where(sel, rel, batch["rel_points"])}


def _to(d, device):
    if isinstance(d, dict):
        return {k: _to(v, device) for k, v in d.items()}
    if isinstance(d, tuple):
        return tuple(_to(v, device) for v in d)
    return d.to(device)


def is_trainable(name: str) -> bool:
    parts = name.split(".")
    return "image_branch" not in parts or "conv_head" in parts or "reduction" in parts


def train_steps(P0: dict, cfg: dict, batches: list, seed: int, w_obj, w_rel, contact_ids, steps: int = 3,
                prec: Precision | None = None, scenes: slice | None = None) -> dict:
    """``steps`` train steps from the parameters ``P0`` on ``batches`` (device
    dicts, one a step), the draws from a CPU generator seeded ``seed``.
    Returns the loss of each step, each leaf's gradient of the first step
    and each leaf's change after the last. ``scenes`` keeps only those
    scenes of each batch after the draws (the fault that drops half the
    batch)."""
    prec = prec or Precision()
    lr, wd = cfg["LR"], cfg["W_DECAY"]
    names = [n for n in P0 if is_trainable(n) and not n.endswith(("running_mean", "running_var"))]
    P = {n: t.detach().clone() for n, t in P0.items()}
    for n in names:
        P[n].requires_grad_(True)
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    gen = torch.Generator().manual_seed(seed)
    augment = cfg["dataset"]["data_augmentation"]
    losses, first_grad = [], None
    for t in range(steps):
        b = batches[t]
        S, O = b["obj_mask"].shape
        E = b["edge_mask"].shape[1]
        d = _to(draw_step(S, O, E, gen, augment), b["obj_points"].device)
        if augment:
            b = augment_batch(b, d, contact_ids)
        keep = d["keep"]
        if scenes is not None:
            b = {k: v_[scenes] for k, v_ in b.items()}
            keep = {k: v_[scenes] for k, v_ in keep.items()}
        with prec.flags():
            obj_lp, rel_lp = sgpn.forward(P, cfg, b, train=True, keep=keep, prec=prec)
            L = sgpn.loss(cfg, obj_lp, rel_lp, b, w_obj, w_rel)
            grads = torch.autograd.grad(L, [P[n] for n in names], allow_unused=True)
        grads = [torch.zeros_like(P[n]) if g is None else g for n, g in zip(names, grads)]
        losses.append(float(L.detach()))
        if t == 0:
            first_grad = {n: g.detach().clone() for n, g in zip(names, grads)}
        with torch.no_grad():
            bc1, bc2 = 1.0 - BETAS[0] ** (t + 1), 1.0 - BETAS[1] ** (t + 1)
            for n, g in zip(names, grads):
                p = P[n]
                p.mul_(1.0 - lr * wd)
                m[n].mul_(BETAS[0]).add_(g, alpha=1.0 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
                denom = (v[n].sqrt() / math.sqrt(bc2)).add_(EPS)
                p.addcdiv_(m[n], denom, value=-lr / bc1)
    change = {n: (P[n].detach() - P0[n]) for n in names}
    return {"losses": losses, "grad": first_grad, "change": change}
