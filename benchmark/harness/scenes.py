"""Synthetic 4D-OR scenes, made from the seed.

Copied from the program's synthetic fixture (``or4d_tpu_torch/data/synthetic.py``
``make_raw_scene`` and the scene preparation of ``data/prep.py``
``prepare_scene``), so that a change to the program cannot move the
yardstick. A scene is a labelled cloud: one Gaussian blob per object
(centre uniform in [-2, 2]^3, sigma 0.35 m, ``points_per_object`` x U(0.5,
1.5) points, a colour per object), uniform background clutter, ground-truth
relations decided by the geometry (LyingOn, Holding, Preparing, CloseTo)
and two hand locations per human. It is prepared as the 4D-OR data
preparation does: object slots in instance order, each object's crop
resampled to the configuration's point count and normalised to zero mean
and unit radius; every directed edge of the fully connected graph gets the
union crop of its two padded (0.2 m) boxes with the mask channel (1 subject,
2 object), resampled and normalised; the subject's hands are carried into
the crop's frame. With ``pair_shared`` a pair's two directions share one
crop with the mask swapped (the program's eval data).

Departure from the fixture: its voxel sweep is left out. Its smallest voxel
is 15 units and these scenes span about 6 m, so the sweep keeps every point
and the resampling draws from all of them; the copy draws from all of them
directly. The random stream is this module's own (one numpy generator per
scene, from the seed and the scene's index), so the same seed gives the same
scenes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CLASSES = ("Patient", "anesthesia_equipment", "human_0", "human_1", "human_2", "human_3", "human_4", "human_5",
           "instrument", "instrument_table", "operating_table", "secondary_table")
RELATIONS = ("Assisting", "Cementing", "Cleaning", "CloseTo", "Cutting", "Drilling", "Hammering", "Holding",
             "LyingOn", "Operating", "Preparing", "Sawing", "Suturing", "Touching", "none")
CONTACT = ("Cementing", "Cleaning", "Cutting", "Drilling", "Hammering", "Sawing", "Suturing", "Touching")
OBJ_TYPES = {"anesthesia_equipment": 0, "operating_table": 1, "instrument_table": 2, "secondary_table": 3,
             "instrument": 4, "human": 5}
_BASE = ("operating_table", "Patient", "human_0", "instrument_table", "anesthesia_equipment", "instrument")
_EXTRA = ("human_1", "human_2", "secondary_table", "human_3", "human_4", "human_5")
NONE = RELATIONS.index("none")
CONTACT_IDS = tuple(RELATIONS.index(r) for r in CONTACT)


def _type(name: str) -> int:
    return OBJ_TYPES["human" if ("human" in name or "Patient" in name) else name]


def _human(name: str) -> bool:
    return "human" in name or name == "Patient"


@dataclasses.dataclass
class Shapes:
    n_objects: int
    points_per_object: int
    max_objects: int
    max_edges: int
    obj_points: int
    rel_points: int
    pair_shared: bool


def _normalise(xyz):
    """Crops (..., P, 3) to zero mean and unit largest radius: the crops,
    their means (..., 1, 3) and radii (..., 1, 1)."""
    mean = xyz.mean(dim=-2, keepdim=True)
    out = xyz - mean
    dist = (out * out).sum(-1, keepdim=True).sqrt().amax(dim=-2, keepdim=True)
    dist = torch.where(dist > 0, dist, torch.ones_like(dist))
    return out / dist, mean, dist


def _resample(rng, n: int, target: int) -> np.ndarray:
    return rng.choice(n, target, replace=n < target)


def _scene(rng: np.random.Generator, sh: Shapes):
    """One scene's cloud, labels, relations and hands, and the point indices
    of its object crops and of its union crops (one a directed edge, or one
    an unordered pair with ``pair_shared``), drawn on the host."""
    names = (_BASE + _EXTRA)[: max(3, sh.n_objects)]
    n = len(names)
    if n > sh.max_objects or n * (n - 1) > sh.max_edges:
        raise ValueError(f"{n} objects do not fit {sh.max_objects} slots / {sh.max_edges} edges")
    centers = rng.uniform(-2.0, 2.0, size=(n, 3))
    xyz, rgb, lab = [], [], []
    for i in range(n):
        c = int(sh.points_per_object * rng.uniform(0.5, 1.5))
        xyz.append(centers[i] + rng.normal(scale=0.35, size=(c, 3)))
        rgb.append(np.clip(rng.uniform(0, 1, size=3) + rng.normal(scale=0.05, size=(c, 3)), 0, 1))
        lab.append(np.full(c, i, np.int32))
    nbg = sh.points_per_object
    xyz.append(rng.uniform(-3, 3, size=(nbg, 3)))
    rgb.append(rng.uniform(0, 1, size=(nbg, 3)))
    lab.append(np.full(nbg, -1, np.int32))
    pts = np.concatenate([np.concatenate(xyz), np.concatenate(rgb)], axis=1).astype(np.float32)
    labels = np.concatenate(lab)

    adj = np.full((n, n), NONE, np.int32)
    for a in range(n):
        for b in range(n):
            if a == b:
                continue
            ca, cb = centers[a], centers[b]
            d = float(np.linalg.norm(ca - cb))
            horiz = float(np.linalg.norm(ca[[0, 2]] - cb[[0, 2]]))
            if _human(names[a]) and "table" in names[b] and horiz < 0.9 and ca[1] > cb[1]:
                adj[a, b] = RELATIONS.index("LyingOn")
            elif _human(names[a]) and names[b] == "instrument" and d < 1.4:
                adj[a, b] = RELATIONS.index("Holding")
            elif _human(names[a]) and names[b] == "anesthesia_equipment" and d < 1.6:
                adj[a, b] = RELATIONS.index("Preparing")
            elif d < 1.2:
                adj[a, b] = RELATIONS.index("CloseTo")
    hands = {i: centers[i] + rng.normal(scale=0.4, size=(2, 3)) for i in range(n) if _human(names[i])}

    members = [np.flatnonzero(labels == i) for i in range(n)]
    lo = np.stack([pts[m, :3].min(0) for m in members]) - np.float32(0.2)
    hi = np.stack([pts[m, :3].max(0) for m in members]) + np.float32(0.2)
    obj_sel = np.stack([m[_resample(rng, len(m), sh.obj_points)] for m in members])
    edges = [(a, b) for a in range(n) for b in range(n) if a != b]
    made = [(a, b) for a, b in edges if not sh.pair_shared or a < b]
    cols = [np.ascontiguousarray(pts[:, k]) for k in range(3)]
    rel_sel = []
    for a, b in made:
        mn, mx = np.minimum(lo[a], lo[b]), np.maximum(hi[a], hi[b])
        inside = np.flatnonzero((cols[0] > mn[0]) & (cols[0] < mx[0]) & (cols[1] > mn[1]) & (cols[1] < mx[1])
                                & (cols[2] > mn[2]) & (cols[2] < mx[2]))
        rel_sel.append(inside[_resample(rng, len(inside), sh.rel_points)])
    return dict(names=names, pts=pts, labels=labels, adj=adj, hands=hands, obj_sel=obj_sel, edges=edges,
                made=made, rel_sel=np.stack(rel_sel))


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` copied into an array numpy allocates, as the batch a data
    loader's ``np.stack`` makes would be held."""
    out = np.empty(tuple(t.shape), np.float32)
    torch.from_numpy(out).copy_(t)
    return out


def make_batch(seed: int, scene_ids, sh: Shapes, device="cpu") -> dict:
    """Host arrays of the scenes ``scene_ids`` (each drawn from (seed, id)),
    with their scan ids, takes and slot names. The draws are made on the
    host; the crops are gathered and normalised as tensors on ``device``."""
    S = len(scene_ids)
    O, E = sh.max_objects, sh.max_edges
    scenes = [_scene(np.random.default_rng([int(seed) & ((1 << 64) - 1), int(i)]), sh) for i in scene_ids]
    offs = np.cumsum([0] + [len(sc["pts"]) for sc in scenes])
    pts = torch.from_numpy(np.concatenate([sc["pts"] for sc in scenes])).to(device)
    labels = torch.from_numpy(np.concatenate([sc["labels"] for sc in scenes])).to(device)

    # object crops: (objects, Po, 6), scattered into their (scene, slot)
    o_scene = np.concatenate([np.full(len(sc["names"]), s) for s, sc in enumerate(scenes)])
    o_slot = np.concatenate([np.arange(len(sc["names"])) for sc in scenes])
    o_sel = torch.from_numpy(np.concatenate([sc["obj_sel"] + offs[s] for s, sc in enumerate(scenes)])).to(device)
    crops = pts[o_sel]
    crops[..., :3] = _normalise(crops[..., :3])[0]
    obj_points = torch.zeros((S, O, sh.obj_points, 6), device=device)
    obj_points[torch.from_numpy(o_scene).to(device), torch.from_numpy(o_slot).to(device)] = crops
    del crops

    # union crops with their mask channel (1 subject, 2 object)
    m_sel = torch.from_numpy(np.concatenate([sc["rel_sel"] + offs[s] for s, sc in enumerate(scenes)])).to(device)
    m_sub = torch.tensor([a for sc in scenes for a, _b in sc["made"]], device=device)[:, None]
    m_obj = torch.tensor([b for sc in scenes for _a, b in sc["made"]], device=device)[:, None]
    lab = labels[m_sel]
    crops = torch.cat([pts[m_sel], ((lab == m_sub).float() + 2.0 * (lab == m_obj).float())[..., None]], dim=-1)
    crops[..., :3], mean, dist = _normalise(crops[..., :3])
    mean, dist = mean.cpu().numpy(), dist.cpu().numpy()
    # every directed edge's slot, the crop it takes, and whether that crop is its pair's reverse
    e_scene, e_slot, e_crop, e_rev = [], [], [], []
    base = 0
    for s, sc in enumerate(scenes):
        k_of = {ab: base + k for k, ab in enumerate(sc["made"])}
        for e, (a, b) in enumerate(sc["edges"]):
            e_scene.append(s)
            e_slot.append(e)
            e_crop.append(k_of.get((a, b), k_of.get((b, a))))
            e_rev.append((a, b) not in k_of)
        base += len(sc["made"])
    rel_points = torch.zeros((S, E, sh.rel_points, 7), device=device)
    rev = torch.tensor(e_rev, device=device)
    ix = (torch.tensor(e_scene, device=device), torch.tensor(e_slot, device=device))
    picked = crops[torch.tensor(e_crop, device=device)]
    m = picked[..., 6]
    picked[..., 6] = torch.where(rev[:, None] & (m > 0), 3.0 - m, m)
    rel_points[ix] = picked
    del crops, picked

    out = {
        "obj_points": _host(obj_points),
        "rel_points": _host(rel_points),
        "edge_index": np.zeros((S, E, 2), np.int32),
        "rel_onehot": np.zeros((S, E, 2 * len(OBJ_TYPES)), np.float32),
        "gt_class": np.zeros((S, O), np.int32),
        "gt_rels": np.full((S, E), NONE, np.int32),
        "obj_mask": np.zeros((S, O), bool),
        "edge_mask": np.zeros((S, E), bool),
        "rel_hand_points": np.zeros((S, E, 2, 3), np.float32),
    }
    del obj_points, rel_points
    j = 0
    for s, sc in enumerate(scenes):
        names = sc["names"]
        n = len(names)
        out["gt_class"][s, :n] = [CLASSES.index(x) for x in names]
        out["obj_mask"][s, :n] = True
        for e, (a, b) in enumerate(sc["edges"]):
            out["edge_index"][s, e] = (a, b)
            out["gt_rels"][s, e] = sc["adj"][a, b]
            out["rel_onehot"][s, e, _type(names[a])] = 1.0
            out["rel_onehot"][s, e, len(OBJ_TYPES) + _type(names[b])] = 1.0
            if a in sc["hands"]:
                k = e_crop[j]
                out["rel_hand_points"][s, e] = (sc["hands"][a] - mean[k]) / dist[k]
            out["edge_mask"][s, e] = True
            j += 1
    out["scan_ids"] = tuple(f"{1 + i % 10}_{i:06d}" for i in scene_ids)
    out["take_idxs"] = tuple(1 + i % 10 for i in scene_ids)
    out["slot_names"] = tuple(sc["names"] for sc in scenes)
    return out


def take(batch: dict, order) -> dict:
    """The batch's scenes in ``order`` (a permutation or a subset)."""
    order = list(order)
    return {k: (v[order] if isinstance(v, np.ndarray) else tuple(v[i] for i in order)) for k, v in batch.items()}
