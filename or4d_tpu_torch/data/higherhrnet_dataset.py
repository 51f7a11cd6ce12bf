"""HigherHRNet OR_4D 2D-keypoint dataset — images, target heatmaps, AE joints
(port of ``or4d_tpu/data/higherhrnet_dataset.py``; numpy, equal to it).

Reference: `external_src/HigherHRNet/higherhrnet_lib/dataset/OR_4D_Dataset.py:24-123`
(image enumeration from timestamp_to_pcd_and_frames_list.json x 6 cameras,
deduped by path, annotations from 2D_keypoint_annotations.json keyed
'{pcd_idx:06d}_{cam}'), `OR_4D_Keypoints.py` (joints assembly, per-scale
targets), `dataset/transforms/transforms.py` (RandomAffineTransform with the
h=200*scale matrix, RandomHorizontalFlip with FLIP_CONFIG['OR_4D']),
`target_generators/target_generators.py` (gaussian max-composite heatmaps,
AE visible-node encoding) and config.yaml (input 512, outputs [128, 256],
sigma 2, max_people 10, rot 30, scale [0.75, 1.5] 'short', translate 40).

Samples are emitted at fixed shapes — heatmaps channels-last, AE joints as
(max_people, J, 2) positions + validity mask at the 1/4-res tag scale (what
`models/higherhrnet.ae_loss` consumes) instead of flattened indices — so
batches stack.

No OpenCV: frames are decoded by the port's JPEG decoder
(:func:`~or4d_tpu_torch.data.jpeg.read_jpeg`, equal to ``cv2.imread`` then
BGR -> RGB on the release's frames) and warped by :func:`warp_affine`, which
computes what ``cv2.warpAffine`` (INTER_LINEAR, BORDER_CONSTANT 0) computes
on uint8 images, bit for bit.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import TAKE_SPLIT

FLIP_INDEX = [0, 1, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12]  # FLIP_CONFIG['OR_4D']
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def affine_matrix(center, scale, res, rot=0.0) -> np.ndarray:
    """The reference's `_get_affine_matrix` (transforms.py:95-119): map the
    h=200*scale box around center onto res, rotating about the OUTPUT
    center (their cropping-direction quirk: rot is negated)."""
    h = 200.0 * scale
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot = -rot
        rot_rad = rot * np.pi / 180.0
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.eye(3)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def affine_joints(joints_xy: np.ndarray, mat: np.ndarray) -> np.ndarray:
    shape = joints_xy.shape
    flat = joints_xy.reshape(-1, 2)
    ones = np.ones((len(flat), 1))
    return (np.concatenate([flat, ones], axis=1) @ mat[:2].T).reshape(shape)


def _invert_affine(mat: np.ndarray) -> np.ndarray:
    """OpenCV's ``invertAffineTransform`` of a 2x3 matrix, in float64:
    (a11, a12, b1, a21, a22, b2) of the destination -> source map."""
    m = np.asarray(mat, np.float64).reshape(-1)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, -m[1] * d, -m[3] * d
    return np.array([a11, a12, -a11 * m[2] - a12 * m[5], a21, a22, -a21 * m[2] - a22 * m[5]])


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding (the product of two float32
    values is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine(img: np.ndarray, mat: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.warpAffine(img, mat, size)`` for a (H, W, C) uint8 image:
    bilinear (INTER_LINEAR), zero outside (BORDER_CONSTANT 0), ``size`` as
    (width, height). OpenCV's arithmetic: the inverse map in float64, cast
    to float32; per output row y, ``y * m12 + b1`` in float32, per pixel
    ``fma(m11, x, that)`` (the same for the other coordinate); floor, the
    fractions, each tap zero outside the image, two horizontal blends and a
    vertical one as float32 fmas, rounded half to even and saturated."""
    f32 = np.float32
    h_in, w_in = img.shape[:2]
    w, h = size
    m = _invert_affine(mat).astype(f32)
    xs = np.arange(w, dtype=f32)[None, :]
    ys = np.arange(h, dtype=f32)[:, None]
    sx = _fma32(m[0], xs, ys * m[1] + m[2])
    sy = _fma32(m[3], xs, ys * m[4] + m[5])
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    ax = (sx - ix.astype(f32))[..., None]
    ay = (sy - iy.astype(f32))[..., None]

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < w_in) & (yy >= 0) & (yy < h_in)
        v = img[np.clip(yy, 0, h_in - 1), np.clip(xx, 0, w_in - 1)].astype(f32)
        return np.where(inside[..., None], v, f32(0))

    p00, p01, p10, p11 = tap(iy, ix), tap(iy, ix + 1), tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = _fma32(ax, p01 - p00, p00)
    bottom = _fma32(ax, p11 - p10, p10)
    return np.clip(np.rint(_fma32(ay, bottom - top, top)), 0, 255).astype(np.uint8)


def render_heatmaps(joints: np.ndarray, output_res: int, num_joints: int, sigma: float = 2.0) -> np.ndarray:
    """HeatmapGenerator semantics (target_generators.py:15-50): per-joint
    gaussian stamps max-composited, with the exact int-truncation and
    3*sigma+1 window of the reference. Returns channels-last (res, res, J)."""
    hms = np.zeros((num_joints, output_res, output_res), np.float32)
    size = int(6 * sigma + 3)
    x = np.arange(0, size, 1, float)
    y = x[:, None]
    x0 = y0 = 3 * sigma + 1
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))
    for p in joints:
        for idx, pt in enumerate(p):
            if pt[2] <= 0:
                continue
            xi, yi = int(pt[0]), int(pt[1])
            if xi < 0 or yi < 0 or xi >= output_res or yi >= output_res:
                continue
            ul = int(np.round(xi - 3 * sigma - 1)), int(np.round(yi - 3 * sigma - 1))
            br = int(np.round(xi + 3 * sigma + 2)), int(np.round(yi + 3 * sigma + 2))
            c, d = max(0, -ul[0]), min(br[0], output_res) - ul[0]
            a, b = max(0, -ul[1]), min(br[1], output_res) - ul[1]
            cc, dd = max(0, ul[0]), min(br[0], output_res)
            aa, bb = max(0, ul[1]), min(br[1], output_res)
            hms[idx, aa:bb, cc:dd] = np.maximum(hms[idx, aa:bb, cc:dd], g[a:b, c:d])
    return hms.transpose(1, 2, 0)


class HigherHRNetDataset:
    """Per-camera-image 2D keypoint samples at fixed TPU shapes."""

    def __init__(
        self,
        root: str | Path,
        split: str,
        input_size: int = 512,
        output_sizes: tuple[int, int] = (128, 256),
        num_joints: int = 14,
        max_people: int = 10,
        sigma: float = 2.0,
        augment: bool = True,
        flip_prob: float = 0.5,
        max_rotation: float = 30.0,
        min_scale: float = 0.75,
        max_scale: float = 1.5,
        max_translate: int = 40,
        remove_images_without_annotations: bool = True,
        take_indices: list[int] | None = None,
    ):
        self.root = Path(root)
        self.input_size = input_size
        self.output_sizes = tuple(output_sizes)
        self.num_joints = num_joints
        self.max_people = max_people
        self.sigma = sigma
        self.augment = augment
        self.flip_prob = flip_prob
        self.max_rotation = max_rotation
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.max_translate = max_translate
        takes = take_indices if take_indices is not None else TAKE_SPLIT[split]
        self.image_dicts = self._enumerate(takes)
        if remove_images_without_annotations:
            self.image_dicts = [d for d in self.image_dicts if len(d["annotations"]) > 0]
        if not self.image_dicts:
            raise RuntimeError(f"no annotated images for split {split} under {self.root}")

    def _enumerate(self, takes) -> list[dict]:
        """OR_4D_Dataset.get_image_dicts (:56-76): every (pcd step, camera)
        pair, deduped by image path, ids assigned in enumeration order."""
        out, seen = [], set()
        image_id = 0
        for take_idx in takes:
            take_root = self.root / f"export_holistic_take{take_idx}_processed"
            frames_path = take_root / "timestamp_to_pcd_and_frames_list.json"
            ann_path = take_root / "2D_keypoint_annotations.json"
            if not frames_path.exists() or not ann_path.exists():
                continue
            frames = json.load(open(frames_path))
            annotations = json.load(open(ann_path))
            for idx, (_, channels) in enumerate(frames):
                for c_idx in range(1, 7):
                    rgb_str = channels[f"color_{c_idx}"]
                    image_path = take_root / "colorimage" / f"camera0{c_idx}_colorimage-{rgb_str}.jpg"
                    if str(image_path) in seen:
                        continue
                    seen.add(str(image_path))
                    out.append(
                        {
                            "take_idx": take_idx,
                            "cam": c_idx,
                            "pcd_idx": f"{idx:06d}",
                            "image_path": image_path,
                            "annotations": annotations.get(f"{str(idx).zfill(6)}_{c_idx}", []),
                            "image_id": image_id,
                        }
                    )
                    image_id += 1
        return out

    def __len__(self) -> int:
        return len(self.image_dicts)

    def _load_image(self, path: Path) -> np.ndarray:
        from or4d_tpu_torch.data.jpeg import read_jpeg

        return read_jpeg(path).numpy()

    def _joints_from_annotations(self, anno: list) -> np.ndarray:
        joints = np.zeros((len(anno), self.num_joints, 3))
        for i, obj in enumerate(anno):
            joints[i, :, :3] = np.array(obj["keypoints"], dtype=np.float64).reshape(-1, 3)
        return joints

    def sample(self, index: int, rng: np.random.Generator | None = None) -> dict:
        """One image -> fixed-shape training arrays:
          image       (S, S, 3) float32, imagenet-normalized
          heatmaps    tuple per scale, (res, res, J)
          joint_pos   (max_people, J, 2) positions at the LOW (tag) scale
          joint_valid (max_people, J) bool
        """
        d = self.image_dicts[index]
        img = self._load_image(d["image_path"])
        joints = self._joints_from_annotations(d["annotations"])
        height, width = img.shape[:2]

        center = np.array((width / 2.0, height / 2.0))
        scale = min(height, width) / 200.0  # SCALE_TYPE 'short'
        aug_rot = 0.0
        if self.augment:
            rng = rng or np.random.default_rng()
            scale *= rng.random() * (self.max_scale - self.min_scale) + self.min_scale
            aug_rot = (rng.random() * 2 - 1) * self.max_rotation
            if self.max_translate > 0:
                center[0] += rng.integers(-int(self.max_translate * scale), int(self.max_translate * scale) + 1)
                center[1] += rng.integers(-int(self.max_translate * scale), int(self.max_translate * scale) + 1)

        joints_per_scale = []
        for res in self.output_sizes:
            mat = affine_matrix(center, scale, (res, res), aug_rot)
            j = joints.copy()
            if len(j):
                j[:, :, :2] = affine_joints(j[:, :, :2], mat)
            joints_per_scale.append(j)
        mat_in = affine_matrix(center, scale, (self.input_size, self.input_size), aug_rot)
        image = warp_affine(img, mat_in[:2], (self.input_size, self.input_size))

        if self.augment and rng.random() < self.flip_prob:
            image = image[:, ::-1].copy()
            for i, res in enumerate(self.output_sizes):
                j = joints_per_scale[i]
                if len(j):
                    j = j[:, FLIP_INDEX]
                    j[:, :, 0] = res - j[:, :, 0] - 1
                joints_per_scale[i] = j

        heatmaps = tuple(
            render_heatmaps(joints_per_scale[i], res, self.num_joints, self.sigma)
            for i, res in enumerate(self.output_sizes)
        )

        # AE supervision at the tag (low) scale — int-truncated pixel
        # positions like the reference JointsGenerator (:93-115)
        low_res = self.output_sizes[0]
        jl = joints_per_scale[0]
        joint_pos = np.zeros((self.max_people, self.num_joints, 2), np.int32)
        joint_valid = np.zeros((self.max_people, self.num_joints), bool)
        for p in range(min(len(jl), self.max_people)):
            for k in range(self.num_joints):
                x, y, v = jl[p, k]
                if v > 0 and 0 <= int(x) < low_res and 0 <= int(y) < low_res:
                    joint_pos[p, k] = (int(x), int(y))
                    joint_valid[p, k] = True

        image = (image.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return {
            "image": image,
            "heatmaps": heatmaps,
            "joint_pos": joint_pos,
            "joint_valid": joint_valid,
            "meta": {"take_idx": d["take_idx"], "cam": d["cam"], "pcd_idx": d["pcd_idx"], "image_id": d["image_id"]},
        }

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0, limit: int | None = None):
        order = np.arange(len(self))
        rng = np.random.default_rng(seed)
        if shuffle:
            rng.shuffle(order)
        if limit:
            order = order[:limit]
        for i in range(0, len(order), batch_size):
            samples = [self.sample(int(j), rng) for j in order[i : i + batch_size]]
            yield {
                "images": np.stack([s["image"] for s in samples]),
                "gt_low": np.stack([s["heatmaps"][0] for s in samples]),
                "gt_high": np.stack([s["heatmaps"][1] for s in samples]),
                "joint_pos": np.stack([s["joint_pos"] for s in samples]),
                "joint_valid": np.stack([s["joint_valid"] for s in samples]),
                "metas": [s["meta"] for s in samples],
            }
