"""Group-Free OR_4D detection dataset — GT boxes from registered scans (port
of ``or4d_tpu/data/groupfree_dataset.py``, numpy on the host).

Reference: `external_src/group_free_3D/OR_4D/OR_4D_detection_dataset.py:39-213`
and `OR_4D/model_util_OR_4D.py:16-60`:

  * scans = every pcd of the split's takes (no relationship filtering);
  * GT objects reuse the L2 registered-scan path (stationary merge, manual
    false_objects, take-10 nudge);
  * each object's OBB: center = AABB midpoint, heading = angle between the
    first PCA component of the centered (x, z) footprint and +x
    (vec_ang in [0, pi]), extents measured after rotating the centered
    points by roty(heading) — the reference's exact recipe, quirks included;
  * coordinates and box sizes are scaled /1000; colors are centered on
    MEAN_COLOR_RGB; the cloud is randomly subsampled to num_points;
  * per-point instance labels map every point whose semantic id is a known
    OBJECT_LABEL_MAP id (humans included — faithful quirk) to the box with
    the nearest center; padded box centers sit at +1000;
  * heading -> (bin of 12, residual), size -> (class == semantic class,
    residual vs mean_size_arr);
  * ret dicts are cached to disk (preprocessed_ret_dicts).

The mean_size_arr release artifact (OR_4D_means.npz) is reproduced by
``compute_mean_size_arr`` over the train split's GT boxes.

The JAX package fits the footprint's first principal component with
scikit-learn's ``PCA(n_components=1)``; the port has no scikit-learn, so
:func:`first_principal_component` computes it as that estimator does
(scikit-learn 1.9, ``svd_solver="auto"``): from the covariance's
eigenvectors (``numpy.linalg.eigh``) for 20 points or more, else from
``scipy.linalg.svd`` of the centred points, with the sign that makes the
largest-magnitude entry positive. The random subsample uses the same numpy
``default_rng`` seeds, so the ret dicts are the JAX package's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import OBJECT_LABEL_MAP, TAKE_SPLIT

MAX_NUM_OBJ = 64
MEAN_COLOR_RGB = np.array([0.49, 0.54, 0.58])
NUM_CLASS = 4
NUM_HEADING_BIN = 12
NUM_SIZE_CLUSTER = 4
# the four detectable classes; their OBJECT_LABEL_MAP ids equal their
# positions in sorted id order, so semantic id == class index (see module doc)
DETECTION_CLASSES = ("anesthesia_equipment", "operating_table", "instrument_table", "secondary_table")
_KNOWN_IDS = np.array(sorted(OBJECT_LABEL_MAP.values()))


def vec_ang(v1, v2) -> float:
    """Angle in [0, pi] between 2D vectors (OR_4D_utils.vec_ang)."""
    cosang = float(np.dot(v1, v2))
    sinang = abs(float(v1[0] * v2[1] - v1[1] * v2[0]))  # |2D cross|
    return float(np.arctan2(sinang, cosang))


def angle2class(angle: float, num_bins: int = NUM_HEADING_BIN) -> tuple[int, float]:
    """Continuous heading -> (bin, residual) (model_util_OR_4D.angle2class)."""
    assert -np.pi <= angle <= np.pi
    angle = angle % (2 * np.pi)
    per = 2 * np.pi / num_bins
    shifted = (angle + per / 2) % (2 * np.pi)
    cls = int(shifted / per)
    return cls, shifted - (cls * per + per / 2)


def class2angle(cls: int, residual: float, num_bins: int = NUM_HEADING_BIN) -> float:
    per = 2 * np.pi / num_bins
    angle = cls * per + residual
    return angle - 2 * np.pi if angle > np.pi else angle


def first_principal_component(X: np.ndarray) -> np.ndarray:
    """``PCA(n_components=1).fit(X).components_[0]`` of (n, f) points, as
    scikit-learn 1.9 computes it (``svd_solver="auto"``), in X's precision
    (float32 or float64; anything else as float64)."""
    X = np.asarray(X)
    X = X if X.dtype in (np.float32, np.float64) else X.astype(np.float64)
    n, f = X.shape
    mean = np.mean(X, axis=0)
    if f <= 1_000 and n >= 10 * f:  # "covariance_eigh"
        C = X.T @ X
        C -= n * np.reshape(mean, (-1, 1)) * np.reshape(mean, (1, -1))
        C /= n - 1
        _vals, vecs = np.linalg.eigh(C)
        Vt = np.flip(vecs, axis=1).T
    else:  # "full"
        from scipy import linalg

        _U, _S, Vt = linalg.svd(X - mean, full_matrices=False)
    # svd_flip(u_based_decision=False): each row's largest |entry| positive
    signs = np.sign(Vt[np.arange(Vt.shape[0]), np.argmax(np.abs(Vt), axis=1)])
    return (Vt * signs[:, None])[0]


def pca_obb(points: np.ndarray) -> np.ndarray:
    """Registered-scan points -> [cx, cy, cz, dx, dy, dz, heading]
    (OR_4D_detection_dataset.py:120-137)."""
    from scipy.spatial.transform import Rotation

    mn, mx = points.min(0), points.max(0)
    center = (mn + mx) / 2
    centered = points - center
    ang = vec_ang(first_principal_component(centered[:, [0, 2]]), [1, 0])
    rot = Rotation.from_euler("xyz", [0, ang, 0]).apply(centered)
    ext = rot.max(0) - rot.min(0)
    return np.array([center[0], center[1], center[2], ext[0], ext[1], ext[2], ang])


def build_scan_ret_dict(root, take_idx, pcd_idx: str, num_points: int,
                        rng: np.random.Generator, max_num_obj: int = MAX_NUM_OBJ) -> dict:
    """One scan -> the reference ret_dict (keys documented at :66-81)."""
    from or4d_tpu_torch.data.pcd_io import read_pcd
    from or4d_tpu_torch.pipeline.instance_labels import load_gt_objects

    pc = read_pcd(Path(root) / f"export_holistic_take{take_idx}_processed" / "pcds" / f"{pcd_idx}.pcd")
    objects = load_gt_objects(root, take_idx, pcd_idx)
    instance_labels = np.load(
        str(Path(root) / "instance_labels" / f"{take_idx}_{pcd_idx}.npz"))["arr_0"].astype(np.int64)

    bboxes = np.zeros((len(objects), 8))
    for i, (name, pts) in enumerate(objects):
        bboxes[i, :7] = pca_obb(pts)
        bboxes[i, 7] = OBJECT_LABEL_MAP[name]

    point_cloud = pc.copy()
    point_cloud[:, :3] /= 1000.0
    bboxes[:, :6] /= 1000.0
    point_cloud[:, 3:] -= MEAN_COLOR_RGB

    n = len(point_cloud)
    choices = rng.choice(n, num_points, replace=n < num_points)
    point_cloud = point_cloud[choices]
    instance_labels = instance_labels[choices]
    semantic_labels = instance_labels.copy()

    k = len(bboxes)
    target_bboxes = np.zeros((max_num_obj, 8))
    mask = np.zeros(max_num_obj)
    mask[:k] = 1
    target_bboxes[:k] = bboxes
    gt_centers = target_bboxes[:, :3].copy()
    gt_centers[k:] += 1000.0  # padded centers far away (:171)

    point_obj_mask = np.zeros(num_points)
    point_instance_label = np.zeros(num_points) - 1
    for inst in np.unique(instance_labels):
        ind = np.where(instance_labels == inst)[0]
        if semantic_labels[ind[0]] in _KNOWN_IDS:
            x = point_cloud[ind, :3]
            center = 0.5 * (x.min(0) + x.max(0))
            ilabel = np.argmin(((center - gt_centers) ** 2).sum(-1))
            point_instance_label[ind] = ilabel
            point_obj_mask[ind] = 1.0

    class_ind = target_bboxes[:k, 7].astype(np.int64)  # ids 0..3 == class idx
    assert (class_ind < NUM_CLASS).all(), "registered objects must be the 4 detection classes"
    size_classes = np.zeros(max_num_obj)
    size_classes[:k] = class_ind
    heading_classes = np.zeros(max_num_obj)
    heading_residuals = np.zeros(max_num_obj)
    for i in range(k):
        heading_classes[i], heading_residuals[i] = angle2class(bboxes[i, 6])
    size_gts = np.zeros((max_num_obj, 3))
    size_gts[:k] = target_bboxes[:k, 3:6]

    return {
        "point_clouds": point_cloud.astype(np.float32),
        "center_label": gt_centers.astype(np.float32),
        "heading_class_label": heading_classes.astype(np.int64),
        "heading_residual_label": heading_residuals.astype(np.float32),
        "size_class_label": size_classes.astype(np.int64),
        "size_gts": size_gts.astype(np.float32),
        "sem_cls_label": size_classes.astype(np.int64),  # size class == sem class here
        "box_label_mask": mask.astype(np.float32),
        "point_obj_mask": point_obj_mask.astype(np.int64),
        "point_instance_label": point_instance_label.astype(np.int64),
    }


class GroupFreeDetectionDataset:
    """Scan-level detection dataset with ret-dict caching and batch stacking."""

    def __init__(self, root, split: str = "train", num_points: int = 20_000,
                 max_num_obj: int = MAX_NUM_OBJ, cache_dir=None, seed: int = 0):
        self.root = Path(root)
        self.num_points = num_points
        self.max_num_obj = max_num_obj
        self.seed = seed
        self.cache_dir = Path(cache_dir) if cache_dir else self.root / "preprocessed_ret_dicts"
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        names = []
        for take_idx in TAKE_SPLIT[split]:
            pcds = sorted((self.root / f"export_holistic_take{take_idx}_processed" / "pcds").glob("*.pcd"))
            names.extend(f"{take_idx}_{p.stem}" for p in pcds)
        self.scan_names = sorted(names)
        if not self.scan_names:
            raise RuntimeError(f"no scans for split {split} under {root}")

    def __len__(self) -> int:
        return len(self.scan_names)

    def __getitem__(self, idx: int) -> dict:
        scan_name = self.scan_names[idx]
        cache = self.cache_dir / f"{scan_name}_{self.num_points}.npz"
        if cache.exists():
            ret = np.load(str(cache), allow_pickle=True)["arr_0"].item()
        else:
            take_idx, pcd_idx = scan_name.split("_")
            rng = np.random.default_rng((self.seed * 1_000_003 + int(take_idx)) * 1_000_003 + int(pcd_idx))
            ret = build_scan_ret_dict(self.root, take_idx, pcd_idx, self.num_points, rng, self.max_num_obj)
            np.savez_compressed(str(cache), ret)
        ret["scan_name"] = scan_name
        return ret

    def batch(self, indices) -> dict:
        """Stack ret dicts into the GroupFreeTrainer feed: point_clouds
        (B,N,6), point_instance_label (B,N), gt dict with the loss keys."""
        rets = [self[int(i)] for i in indices]
        stack = lambda key: np.stack([r[key] for r in rets])
        size_class = stack("size_class_label")
        mean = self.mean_size_arr()
        return {
            "point_clouds": stack("point_clouds"),
            "point_instance_label": stack("point_instance_label"),
            "gt": {
                "center": stack("center_label"),
                "size": stack("size_gts"),
                "size_class": size_class,
                "size_residual": stack("size_gts") - mean[size_class],
                "heading_class": stack("heading_class_label"),
                "heading_residual": stack("heading_residual_label"),
                "sem_class": stack("sem_cls_label"),
                "mask": stack("box_label_mask"),
            },
        }

    def mean_size_arr(self) -> np.ndarray:
        """The OR_4D_means.npz artifact: per-class mean box extents over this
        dataset's GT boxes (cached)."""
        cache = self.cache_dir / "OR_4D_means.npz"
        if cache.exists():
            return np.load(str(cache))["arr_0"]
        arr = compute_mean_size_arr(self)
        np.savez_compressed(str(cache), arr)
        return arr


def compute_mean_size_arr(dataset: GroupFreeDetectionDataset) -> np.ndarray:
    """Per-class mean (dx, dy, dz) over GT boxes (the release artifact's
    derivation; model_util_OR_4D.py:29)."""
    sums = np.zeros((NUM_SIZE_CLUSTER, 3))
    counts = np.zeros(NUM_SIZE_CLUSTER)
    for i in range(len(dataset)):
        ret = dataset[i]
        m = ret["box_label_mask"] > 0
        for cls, size in zip(ret["size_class_label"][m], ret["size_gts"][m]):
            sums[int(cls)] += size
            counts[int(cls)] += 1
    counts = np.maximum(counts, 1)
    arr = sums / counts[:, None]
    arr[counts == 1] = np.maximum(arr[counts == 1], 1e-3)
    return np.maximum(arr, 1e-3)
