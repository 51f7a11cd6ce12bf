"""Oriented 3D box geometry: corners, oriented IoU, reference-parity NMS
(a copy of ``or4d_tpu/ops/box_geometry.py``, which is numpy only).

Reference semantics (external_src/group_free_3D/utils/box_util.py, 318 LoC +
utils/nms.py + utils/eval_det.py:62-79), re-implemented from scratch:

  * get_3d_box_batch (:236-262): size (l, w, h) maps to (x, z, y) extents,
    heading rotates about +y, corners 0-3 carry +h/2 ("top"), 4-7 carry -h/2;
  * box3d_iou (:99-122): bird's-eye intersection of the (x, z) footprints via
    convex polygon clipping (corners 3..0 are counter-clockwise), times the
    y-extent overlap, over the union of volumes;
  * the NMS actually shipped (ap_helper.py:168-189 with use_3d_nms=True,
    cls_nms=True): axis-aligned IoU over the AABBs OF THE ROTATED CORNERS,
    suppression only within the same class, ties processed in ascending
    score order with np.argsort;
  * AP (eval_det.py get_iou_obb): true oriented IoU.

Host-side numpy: these run at evaluation time on decoded boxes (K <= 128
per scan); the detector itself runs on the card.
"""

from __future__ import annotations

import numpy as np


def rot_y(t: np.ndarray) -> np.ndarray:
    """Batched rotation about +y (roty_batch :201-215)."""
    t = np.asarray(t, np.float64)
    out = np.zeros(t.shape + (3, 3))
    c, s = np.cos(t), np.sin(t)
    out[..., 0, 0] = c
    out[..., 0, 2] = s
    out[..., 1, 1] = 1.0
    out[..., 2, 0] = -s
    out[..., 2, 2] = c
    return out


def box_corners(center: np.ndarray, size: np.ndarray, heading: np.ndarray) -> np.ndarray:
    """(..., 3), (..., 3) as (l, w, h), (...,) -> (..., 8, 3) corners in the
    get_3d_box_batch layout."""
    center = np.asarray(center, np.float64)
    size = np.asarray(size, np.float64)
    l, w, h = size[..., 0:1], size[..., 1:2], size[..., 2:3]
    sx = np.concatenate([l, l, -l, -l, l, l, -l, -l], axis=-1) / 2
    sy = np.concatenate([h, h, h, h, -h, -h, -h, -h], axis=-1) / 2
    sz = np.concatenate([w, -w, -w, w, w, -w, -w, w], axis=-1) / 2
    local = np.stack([sx, sy, sz], axis=-1)  # (..., 8, 3)
    R = rot_y(heading)
    return np.einsum("...ij,...kj->...ki", R, local) + center[..., None, :]


def polygon_area(pts: np.ndarray) -> float:
    """Shoelace area magnitude (poly_area :67-69)."""
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray | None:
    """Sutherland–Hodgman clip of ``subject`` by convex counter-clockwise
    ``clip`` (polygon_clip :17-64 semantics); None when nothing remains."""
    output = list(map(tuple, subject))
    cp1 = tuple(clip[-1])
    for cp2 in map(tuple, clip):
        if not output:
            return None
        inputs, output = output, []
        s = inputs[-1]

        def inside(p):
            return (cp2[0] - cp1[0]) * (p[1] - cp1[1]) > (cp2[1] - cp1[1]) * (p[0] - cp1[0])

        def intersection(a, b):
            dc = (cp1[0] - cp2[0], cp1[1] - cp2[1])
            dp = (a[0] - b[0], a[1] - b[1])
            n1 = cp1[0] * cp2[1] - cp1[1] * cp2[0]
            n2 = a[0] * b[1] - a[1] * b[0]
            n3 = dc[0] * dp[1] - dc[1] * dp[0]
            if abs(n3) < 1e-12:
                return a
            return ((n1 * dp[0] - n2 * dc[0]) / n3, (n1 * dp[1] - n2 * dc[1]) / n3)

        for e in inputs:
            if inside(e):
                if not inside(s):
                    output.append(intersection(s, e))
                output.append(e)
            elif inside(s):
                output.append(intersection(s, e))
            s = e
        cp1 = cp2
    return np.asarray(output) if output else None


def oriented_box_iou(corners1: np.ndarray, corners2: np.ndarray) -> tuple[float, float]:
    """(iou_3d, iou_2d) of two corner boxes (box3d_iou :99-122)."""
    rect1 = corners1[3::-1][:, [0, 2]]  # counter-clockwise footprint
    rect2 = corners2[3::-1][:, [0, 2]]
    area1 = polygon_area(rect1)
    area2 = polygon_area(rect2)
    inter = clip_polygon(rect1, rect2)
    inter_area = polygon_area(inter) if inter is not None and len(inter) >= 3 else 0.0
    iou_2d = inter_area / max(area1 + area2 - inter_area, 1e-12)
    ymax = min(corners1[0, 1], corners2[0, 1])
    ymin = max(corners1[4, 1], corners2[4, 1])
    inter_vol = inter_area * max(0.0, ymax - ymin)
    vol1 = _box_vol(corners1)
    vol2 = _box_vol(corners2)
    return inter_vol / max(vol1 + vol2 - inter_vol, 1e-12), iou_2d


def _box_vol(corners: np.ndarray) -> float:
    a = np.linalg.norm(corners[0] - corners[1])
    b = np.linalg.norm(corners[1] - corners[2])
    c = np.linalg.norm(corners[0] - corners[4])
    return a * b * c


def oriented_iou_from_params(c1, s1, h1, c2, s2, h2) -> float:
    """Oriented 3D IoU straight from (center, size, heading) params."""
    return oriented_box_iou(box_corners(c1, s1, h1), box_corners(c2, s2, h2))[0]


def nms_3d_samecls(
    centers: np.ndarray,
    sizes: np.ndarray,
    headings: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    iou_threshold: float = 0.25,
    old_type: bool = False,
) -> np.ndarray:
    """The reference's shipped NMS (nms_3d_faster_samecls via
    ap_helper.py:168-189): suppression by axis-aligned IoU over the AABBs of
    the heading-rotated corners, restricted to same-class pairs. Returns kept
    indices in pick order (descending score)."""
    centers, sizes, scores = map(np.asarray, (centers, sizes, scores))
    headings = np.asarray(headings)
    classes = np.asarray(classes)
    corners = box_corners(centers, sizes, headings)  # (K, 8, 3)
    mins = corners.min(axis=1)
    maxs = corners.max(axis=1)
    area = np.prod(maxs - mins, axis=1)

    order = np.argsort(scores)  # ascending; pick from the back
    pick = []
    while order.size:
        i = order[-1]
        pick.append(int(i))
        rest = order[:-1]
        inter_min = np.maximum(mins[i], mins[rest])
        inter_max = np.minimum(maxs[i], maxs[rest])
        inter = np.prod(np.clip(inter_max - inter_min, 0, None), axis=1)
        if old_type:
            o = inter / np.maximum(area[rest], 1e-12)
        else:
            o = inter / np.maximum(area[i] + area[rest] - inter, 1e-12)
        o = o * (classes[i] == classes[rest])
        order = rest[o <= iou_threshold]
    return np.asarray(pick, np.int64)
