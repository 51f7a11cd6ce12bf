"""Training augmentation (port of ``or4d_tpu/data/augment.py``).

Reference ``scene_graph_helpers/dataset/augmentation_utils.py``:
  * per object crop: scalar brightness jitter +-0.1 on rgb, per-channel
    colour jitter, clamp to [0, 1], xyz shift +-0.15, rotation about the
    crop's centroid — y-euler +-45, then the reference's quirk of applying
    the "x" rotation about the y axis too (+-20), then z +-20 — and scale
    U(0.4, 1.6) (:7-41);
  * per relation crop: for contact relations, zero the points farther than
    a random threshold from both hands (:44-62); then the object
    augmentation on the whole crop; then a milder pass on the subject
    (mask == 1) and one on the object (mask == 2) points;
  * applied to a scene with probability 0.75 (or_dataset.py:122-127).

Every crop of a batch is transformed at once as plain tensor ops on the
batch's device. The random draws are made apart from the arithmetic:
:func:`draw_augment` takes them from a ``torch.Generator`` on the CPU (so a
run on the card and one on the CPU draw the same numbers), and
:func:`augment_batch_with` applies given draws, so a test can hand it the
values the JAX package draws from its key tree.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from or4d_tpu_torch.data.scene_batch import SceneBatch
from or4d_tpu_torch.data.vocab import CONTACT_RELATIONS, DEFAULT_VOCAB

OBJ_CFG = {"brightness": 0.1, "colors": 0.05, "x_rot": 20.0, "y_rot": 45.0, "z_rot": 20.0, "shift": 0.15,
           "scale": (0.4, 1.6)}
REL_CFG = {"brightness": 0.1, "colors": 0.025, "x_rot": 10.0, "y_rot": 20.0, "z_rot": 10.0, "shift": 0.1,
           "scale": (0.4, 1.6)}
HAND_THRESHOLD = 0.2
APPLY_P = 0.75

# contact-relation ids under the default vocab
CONTACT_IDS = tuple(DEFAULT_VOCAB.relation_index(r) for r in CONTACT_RELATIONS)

# one crop's draws: name -> (trailing shape, (low, high) from a config)
_CROP_DRAWS = {
    "brightness": ((), lambda c: (-c["brightness"], c["brightness"])),
    "colors": ((3,), lambda c: (-c["colors"], c["colors"])),
    "shift": ((3,), lambda c: (-c["shift"], c["shift"])),
    "y_rot": ((), lambda c: (-c["y_rot"], c["y_rot"])),
    "x_rot": ((), lambda c: (-c["x_rot"], c["x_rot"])),
    "z_rot": ((), lambda c: (-c["z_rot"], c["z_rot"])),
    "scale": ((), lambda c: c["scale"]),
}


@dataclasses.dataclass
class AugmentDraws:
    """Every random value one batch's augmentation uses (float32 unless
    noted):

      apply     (S,) bool   scene augmented or not
      obj       crop draws over (S, O) with OBJ_CFG ranges
      rel_thres (S, E)      hand-distance threshold in [0.2, 1)
      rel       three crop draws over (S, E): the whole crop (OBJ_CFG), the
                subject points and the object points (REL_CFG)

    A crop draw is a dict brightness (...), colors (..., 3), shift (..., 3),
    y_rot, x_rot, z_rot (...) in degrees, scale (...), each in its range."""

    apply: torch.Tensor
    obj: dict
    rel_thres: torch.Tensor
    rel: tuple

    def to(self, device) -> "AugmentDraws":
        mv = lambda d: {k: v.to(device) for k, v in d.items()}
        return AugmentDraws(self.apply.to(device), mv(self.obj), self.rel_thres.to(device),
                            tuple(mv(d) for d in self.rel))


def _uniform(shape, low, high, generator):
    return torch.rand(shape, generator=generator) * (high - low) + low


def _crop_draws(lead, cfg, generator) -> dict:
    return {k: _uniform(tuple(lead) + tail, *rng(cfg), generator) for k, (tail, rng) in _CROP_DRAWS.items()}


def draw_augment(S: int, O: int, E: int, generator: torch.Generator | None) -> AugmentDraws:
    """Draws for an (S scenes, O object slots, E edge slots) batch, on the
    CPU from ``generator``."""
    apply = torch.rand(S, generator=generator) < APPLY_P
    obj = _crop_draws((S, O), OBJ_CFG, generator)
    thres = _uniform((S, E), HAND_THRESHOLD, 1.0, generator)
    rel = (_crop_draws((S, E), OBJ_CFG, generator), _crop_draws((S, E), REL_CFG, generator),
           _crop_draws((S, E), REL_CFG, generator))
    return AugmentDraws(apply, obj, thres, rel)


def _rot(deg: torch.Tensor, axis: str) -> torch.Tensor:
    """(..., 3, 3) rotation matrices about y or z, as the reference builds
    them."""
    r = deg * (math.pi / 180.0)
    c, s = torch.cos(r), torch.sin(r)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    if axis == "y":
        rows = [[c, z, s], [z, o, z], [-s, z, c]]
    else:
        rows = [[c, -s, z], [s, c, z], [z, z, o]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def augment_crops(points: torch.Tensor, d: dict, subset: torch.Tensor | None = None) -> torch.Tensor:
    """Crops (..., P, C>=6), xyz in [..., :3] and rgb in [..., 3:6]; other
    channels pass through. ``d``: crop draws over the leading dims;
    ``subset`` (..., P) bool restricts the transform to those points."""
    xyz, rgb = points[..., :3], points[..., 3:6]
    m = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device) if subset is None else subset
    mf = m[..., None].to(points.dtype)

    rgb_new = rgb + d["brightness"][..., None, None]
    rgb_new = torch.clamp(rgb_new + d["colors"][..., None, :], 0.0, 1.0)

    xyz_new = xyz + d["shift"][..., None, :]
    count = torch.clamp(mf.sum(-2), min=1.0)  # (..., 1)
    center = (xyz_new * mf).sum(-2) / count  # (..., 3)
    centered = xyz_new - center[..., None, :]
    # the reference right-multiplies: p' = p @ R_y(y) @ R_y(x) @ R_z(z)
    rotated = centered @ _rot(d["y_rot"], "y") @ _rot(d["x_rot"], "y") @ _rot(d["z_rot"], "z")
    xyz_new = rotated * d["scale"][..., None, None] + center[..., None, :]

    out_xyz = torch.where(m[..., None], xyz_new, xyz)
    out_rgb = torch.where(m[..., None], rgb_new, rgb)
    return torch.cat([out_xyz, out_rgb, points[..., 6:]], dim=-1)


def augment_rel_crops(points, hand_points, is_contact, thres, passes) -> torch.Tensor:
    """Relation crops (..., P, 7): hand-proximity zeroing of contact edges,
    then the whole-crop pass and the subject and object passes."""
    diff = points[..., :, None, :3] - hand_points[..., None, :, :]  # (..., P, 2, 3)
    dist = torch.sqrt((diff * diff).sum(-1)).amin(-1)  # (..., P)
    zero = is_contact[..., None] & (dist > thres[..., None])
    points = torch.where(zero[..., None], torch.zeros((), dtype=points.dtype, device=points.device), points)
    points = augment_crops(points, passes[0])
    points = augment_crops(points, passes[1], points[..., 6] == 1)
    return augment_crops(points, passes[2], points[..., 6] == 2)


def augment_batch_with(batch: SceneBatch, draws: AugmentDraws) -> SceneBatch:
    """The batch (tensors) with augmented obj_points and rel_points, from
    the given draws (on the batch's device)."""
    ids = torch.tensor(CONTACT_IDS, device=batch.gt_rels.device)
    if batch.gt_rels.dim() == 3:  # MULTI_REL multi-hot (S, E, R): any contact bit set
        contact = batch.gt_rels[..., ids].amax(-1) > 0.5
    else:
        contact = torch.isin(batch.gt_rels, ids)
    new_obj = augment_crops(batch.obj_points, draws.obj)
    new_rel = augment_rel_crops(batch.rel_points, batch.rel_hand_points, contact, draws.rel_thres, draws.rel)
    sel = draws.apply[:, None, None, None]
    return dataclasses.replace(batch, obj_points=torch.where(sel, new_obj, batch.obj_points),
                               rel_points=torch.where(sel, new_rel, batch.rel_points))


def augment_batch(batch: SceneBatch, generator: torch.Generator | None) -> SceneBatch:
    """The reference augmentation, with its draws taken from ``generator``."""
    S, O = batch.obj_points.shape[:2]
    E = batch.rel_points.shape[1]
    return augment_batch_with(batch, draw_augment(S, O, E, generator).to(batch.obj_points.device))
