"""Camera calibration + coordinate transforms for the 4D-OR capture rig
(port of ``or4d_tpu/data/cameras.py``; numpy, the same arithmetic).

Reference: `helpers/utils.py`:
  * load_cam_infos (:50-95): per-camera json -> color intrinsics, extrinsics
    (depth extrinsics composed with the color2depth transform), fov/principal
    point, radial+tangential distortion;
  * pose-tool <-> OR-4D coordinate transforms (:13-47): axis swap (y<->z),
    y-flip, z offset 1000, scale 25 — both directions;
  * DEPTH_SCALING=2000 applied to registered-object translations
    (helpers/object_pose_utils.py:9-26).

Quaternion -> rotation is implemented inline (scipy-compatible xyzw order)
so the module has no scipy dependency.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from or4d_tpu_torch.config import DEPTH_SCALING

# voxelpose project_points_radial_OR_4D divides world coords by 500
# (external_src/voxelpose/voxelpose_lib/utils/cameras.py:56-63)
VOXELPOSE_WORLD_SCALE = 500.0


def quat_to_matrix(x: float, y: float, z: float, w: float) -> np.ndarray:
    """xyzw quaternion -> 3x3 rotation (scipy Rotation.from_quat order)."""
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def coord_transform_or4d_to_pose_tool(arr: np.ndarray) -> np.ndarray:
    """OR-4D frame -> pose-tool frame (helpers/utils.py:13-34)."""
    orig_1d = arr.ndim == 1
    a = np.atleast_2d(np.asarray(arr, np.float64)).copy()
    a = a[:, [0, 2, 1]]
    a[:, 1] *= -1
    a[:, 2] -= 1000
    a /= 25
    return a[0] if orig_1d else a


def coord_transform_pose_tool_to_or4d(arr: np.ndarray) -> np.ndarray:
    """Pose-tool frame -> OR-4D frame (helpers/utils.py:37-47)."""
    a = np.atleast_2d(np.asarray(arr, np.float64)).copy()
    a *= 25
    a[:, 2] += 1000
    a[:, 1] *= -1
    a = a[:, [0, 2, 1]]
    return a


def _mat4(rot: dict, trans: dict) -> np.ndarray:
    m = np.zeros((4, 4), np.float32)
    m[:3, :3] = quat_to_matrix(rot["x"], rot["y"], rot["z"], rot["w"])
    m[:, 3] = [trans["m00"], trans["m10"], trans["m20"], 1]
    return m


def load_cam_infos(root_path: str | Path, cam_count: int = 6) -> dict[str, dict]:
    """Parse camera0{i}.json calibration files (load_cam_infos :50-95)."""
    root_path = Path(root_path)
    out = {}
    for c_idx in range(1, cam_count + 1):
        cam = json.loads((root_path / f"camera0{c_idx}.json").read_text())["value0"]
        ij = cam["color_parameters"]["intrinsics_matrix"]
        # column-major json -> row-major matrix (reference layout)
        intrinsics = np.array(
            [
                [ij["m00"], ij["m10"], ij["m20"]],
                [ij["m01"], ij["m11"], ij["m21"]],
                [ij["m02"], ij["m12"], ij["m22"]],
            ]
        )
        extr = _mat4(cam["camera_pose"]["rotation"], cam["camera_pose"]["translation"])
        c2d = _mat4(cam["color2depth_transform"]["rotation"], cam["color2depth_transform"]["translation"])
        depth_extrinsics = extr.copy()
        extrinsics = extr @ c2d  # depth-frame extrinsics -> color frame

        cp = cam["color_parameters"]
        rp = cp["radial_distortion"]
        tp = cp["tangential_distortion"]
        out[f"camera0{c_idx}"] = {
            "intrinsics": intrinsics,
            "extrinsics": extrinsics,
            "depth_extrinsics": depth_extrinsics,
            "fov_x": cp["fov_x"],
            "fov_y": cp["fov_y"],
            "c_x": cp["c_x"],
            "c_y": cp["c_y"],
            "width": cp["width"],
            "height": cp["height"],
            "radial_params": tuple(rp[f"m{i}0"] for i in range(6)),
            "tangential_params": (tp["m00"], tp["m10"]),
        }
    return out


def cam_infos_to_voxelpose(cam_infos: dict[str, dict]) -> dict[str, np.ndarray]:
    """Stack load_cam_infos output into the batched camera dict the
    VoxelPose projection consumes ({R, T, f, c, size}).

    The reference projection (voxelpose OR_4D.py:236-247) is
    `inv(extrinsics)` (world -> camera) followed by diag(1, -1, -1) —
    Azure-Kinect camera axes vs the image convention ("this is needed") —
    then the fov_x/fov_y/c_x/c_y pinhole, with world points divided by 500
    (extrinsics live in meters, OR_4D export coords in meters*500). With
    `project_points` computing R @ (p - T) on EXPORT-scale points, that
    folds to R = F @ ext[:3,:3].T and T = 500 * ext[:3,3]; the uniform
    1/500 cancels in the x/z perspective divide."""
    flip = np.diag([1.0, -1.0, -1.0])
    Rs, Ts, fs, cs, sizes = [], [], [], [], []
    for name in sorted(cam_infos):
        ci = cam_infos[name]
        ext = np.asarray(ci["extrinsics"], np.float64)
        R_wc = flip @ ext[:3, :3].T
        T = ext[:3, 3] * VOXELPOSE_WORLD_SCALE
        Rs.append(R_wc)
        Ts.append(T)
        fs.append([ci["fov_x"], ci["fov_y"]])
        cs.append([ci["c_x"], ci["c_y"]])
        sizes.append([ci["width"], ci["height"]])
    return {
        "R": np.stack(Rs).astype(np.float32),
        "T": np.stack(Ts).astype(np.float32),
        "f": np.asarray(fs, np.float32),
        "c": np.asarray(cs, np.float32),
        "size": np.asarray(sizes, np.float32),
    }


def scale_registered_translation(transformation: np.ndarray) -> np.ndarray:
    """Registered-object scan transforms store translations in depth units;
    scale by DEPTH_SCALING (object_pose_utils.py:9-14)."""
    t = np.asarray(transformation, np.float64).copy()
    t[:3, 3] *= DEPTH_SCALING
    return t
