"""L1 inference drivers — the reference interchange artifacts (port of
``or4d_tpu/pipeline/perception_infer.py``).

  * HigherHRNet 2D poses -> `pred_or_4d_hrnet_coco_{split}.npz`
    (tools/calculate_2d_human_pose.py:94-207): one pickled dict under
    ``arr_0``, {"{take}_camera0{c}_colorimage-{idx}.jpg": (P, J, 3)};
  * VoxelPose 3D poses -> `pred_{take}_{frame}.npy`
    (get_human_poses_4D_OR.py:103-109): (num_people, 14, 3) world mm;
  * Group-Free boxes -> `group_free_predictions/{take}_{scan}.npz`.

Each driver runs the model's eval forward on the model's device and queues
the next item's load and forward before the current item's host-side work
(:func:`~or4d_tpu_torch.utils.stream.lookahead`).

Group-Free reference: `group_free_3D/OR_4D/infer.py:153-226` and
`ap_helper.dump_predictions` (:263-322): per scan one
``group_free_predictions/{take}_{scan}.npz`` holding a pickled dict under
``arr_0`` with the confidence-filtered boxes (``bboxes`` (K, 7) as center,
size, heading; ``scores``; ``classes``) and the same after same-class NMS
(``*_nms``, what ``compute_instance_labels`` consumes). The file is read
back with :func:`~or4d_tpu_torch.pipeline.instance_labels.load_boxes_npz`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def _host(*tensors) -> tuple:
    """Copies of ``tensors`` on the host, queued without blocking, and an
    event to wait on before reading them (None on the CPU)."""
    out = tuple(t.to("cpu", non_blocking=True) for t in tensors)
    event = None
    if tensors[0].device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return out, event


def write_2d_pose_npz(path: str | Path, per_frame_people: dict[str, np.ndarray]) -> None:
    """{"{take}_camera0{c}_colorimage-{idx}.jpg": (P, J, 3) [x, y, score]}
    -> the reference HRNet dump format: ONE pickled dict under 'arr_0'
    (voxelpose OR_4D.py:113-115 reads np.load(...)['arr_0'].item())."""
    np.savez_compressed(path, np.array({k: np.asarray(v) for k, v in per_frame_people.items()}, dtype=object))


def _maps(low: torch.Tensor, high: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One HigherHRNet forward's (1, ...) outputs, aggregated: the heatmaps
    (:func:`aggregate_heatmaps`) and the tags upsampled to them, (H, W, J)
    each, on their device."""
    from or4d_tpu_torch.models.higherhrnet import aggregate_heatmaps, resize_bilinear

    J = high.shape[-1]
    return aggregate_heatmaps(low[0], high[0]), resize_bilinear(low[0][..., J:], tuple(high.shape[1:3]))


def _hrnet_maps(model, image: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_maps` of one (S, S, 3) image's eval forward."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        return _maps(*model(torch.as_tensor(np.asarray(image, np.float32)[None], device=dev), train=False))


def _parse_people(agg: np.ndarray, tags: np.ndarray, max_people: int) -> np.ndarray:
    """The reference HeatmapParser grouping (Munkres matching + adjust +
    refine, core/group.py) of one image's maps: (P, J, 3) [x, y, score]."""
    from or4d_tpu_torch.pipeline.ae_grouping import parse_heatmaps

    J = agg.shape[-1]
    # parser eats channels-first (J, H, W)
    people, _scores = parse_heatmaps(agg.transpose(2, 0, 1), tags.transpose(2, 0, 1), max_people=max_people)
    return people[..., :3] if len(people) else np.zeros((0, J, 3))


def _group_2d_people(low: torch.Tensor, high: torch.Tensor, max_people: int) -> np.ndarray:
    """Post-processing of one HigherHRNet forward's (1, ...) outputs:
    heatmap aggregation + the reference HeatmapParser grouping."""
    return _parse_people(*(t.cpu().numpy() for t in _maps(low, high)), max_people)


def run_2d_inference_for_voxelpose(model, dataset, out_path: str | Path, max_people: int = 10) -> dict:
    """Enumerate a ``HigherHRNetDataset``'s images (no augmentation), run
    HigherHRNet + the HeatmapParser, and dump the npz VoxelPose's db builder
    consumes (`pred_or_4d_hrnet_coco_{split}.npz`), keyed by the reference
    identifier '{take}_{image_name}'. Images stream one at a time; the next
    image's load, forward and aggregation are queued before the current
    image's grouping on the host. Returns the dict written."""
    from or4d_tpu_torch.utils.stream import lookahead

    model.eval()
    preds: dict[str, np.ndarray] = {}

    def dispatch(i_d):
        i, d = i_d
        maps, event = _host(*_hrnet_maps(model, dataset.sample(i)["image"]))
        return f"{d['take_idx']}_{d['image_path'].name}", maps, event

    def consume(item):
        key, (agg, tags), event = item
        if event is not None:
            event.synchronize()
        preds[key] = _parse_people(agg.numpy(), tags.numpy(), max_people)

    lookahead(enumerate(dataset.image_dicts), dispatch, consume)
    write_2d_pose_npz(out_path, preds)
    return preds


def infer_2d_poses(model, images_by_key: dict[str, np.ndarray], max_people: int = 10) -> dict[str, np.ndarray]:
    """Run HigherHRNet per camera image; group with the reference
    HeatmapParser."""
    model.eval()
    out = {}
    for key, img in images_by_key.items():
        agg, tags = _hrnet_maps(model, img)
        out[key] = _parse_people(agg.cpu().numpy(), tags.cpu().numpy(), max_people)
    return out


def _voxelpose_forward(model, heatmaps, cameras: dict, heatmap_scale):
    dev = next(model.parameters()).device
    with torch.no_grad():
        return model(torch.as_tensor(np.asarray(heatmaps, np.float32), device=dev), cameras,
                     torch.as_tensor(np.asarray(heatmap_scale, np.float32), device=dev), train=False)


def infer_3d_poses(model, heatmaps: np.ndarray, cameras: dict, heatmap_scale, out_path: str | Path,
                   threshold: float = 0.1) -> np.ndarray:
    """VoxelPose eval forward of one frame's (C, J, H, W) heatmaps -> the
    (P, 14, 3) world poses scoring above ``threshold``; writes
    ``out_path`` (npy). ``cameras`` from ``cameras_on``."""
    model.eval()
    poses, scores, _c, _r = _voxelpose_forward(model, heatmaps, cameras, heatmap_scale)
    result = poses.cpu().numpy()[scores.cpu().numpy() > threshold]
    np.save(out_path, result)
    return result


def run_3d_pose_inference_for_take(model, dataset, take_idx: int, out_dir: str | Path, threshold: float = 0.1) -> int:
    """Per-take VoxelPose inference (get_human_poses_4D_OR.py:41-112): the
    take's frames of ``dataset`` through the eval forward, and
    ``pred_{take}_{frame}.npy`` for every frame with at least one person
    scoring above ``threshold``; empty frames are skipped as in the
    reference (:106-107). Returns the number of files written."""
    from or4d_tpu_torch.train.perception_trainers import cameras_on
    from or4d_tpu_torch.utils.stream import lookahead

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    model.eval()
    cameras = cameras_on(dataset.cameras, next(model.parameters()).device)

    def dispatch(i_rec):
        i, rec = i_rec
        poses, scores, _c, _r = _voxelpose_forward(model, dataset.sample(i)["input_heatmaps"], cameras,
                                                   dataset.heatmap_scale)
        return (rec, *_host(poses, scores))

    def consume(item):
        rec, (poses, scores), event = item
        if event is not None:
            event.synchronize()
        result = poses.numpy()[scores.numpy() > threshold]
        if len(result) == 0:
            return 0
        np.save(out_dir / f"pred_{take_idx}_{rec['pcd_idx']}.npy", result)
        return 1

    frames = [(i, rec) for i, rec in enumerate(dataset.db) if rec["take_idx"] == take_idx]
    return sum(lookahead(frames, dispatch, consume))


def _forward(model, point_cloud: np.ndarray, msa: torch.Tensor) -> dict:
    """The eval forward of one (N, C) scan; its ``last`` head on the card."""
    dev = msa.device
    with torch.no_grad():
        return model(torch.as_tensor(np.asarray(point_cloud, np.float32)[None], device=dev), msa, train=False)


def _mean_sizes(model, mean_size_arr) -> torch.Tensor:
    from or4d_tpu_torch.models.groupfree import mean_sizes

    return mean_sizes(mean_size_arr, next(model.parameters()).device)


def infer_boxes(model, point_cloud: np.ndarray, mean_size_arr: np.ndarray, out_path: str | Path,
                nms_iou: float = 0.25, score_threshold: float = 0.05) -> dict:
    """Group-Free eval forward of one scan -> boxes npz in the reference
    dict format; returns the dict."""
    msa = _mean_sizes(model, mean_size_arr)
    decoded = _decoded(_forward(model, point_cloud, msa), mean_size_arr)
    if msa.device.type == "cuda":
        torch.cuda.synchronize(msa.device)  # the host copies are asynchronous
    return _finish_boxes(decoded, out_path, nms_iou, score_threshold)


def _decoded(out: dict, mean_size_arr) -> tuple:
    """decode_boxes of the last head, as float32/int64 host arrays of scan 0
    (copied without blocking the stream; read them after a sync)."""
    from or4d_tpu_torch.models.groupfree import decode_boxes

    return tuple(x[0].to("cpu", non_blocking=True) for x in decode_boxes(out["last"], mean_size_arr))


def _finish_boxes(decoded, out_path, nms_iou: float, score_threshold: float) -> dict:
    """Host-side tail of one Group-Free forward: confidence filter,
    same-class NMS, write the reference npz dict."""
    from or4d_tpu_torch.models.groupfree import nms_3d_samecls

    center, size, heading, cls, score = (x.numpy() for x in decoded)
    cls = cls.astype(np.int32)  # jnp.argmax's dtype, as the JAX package writes it
    ok = score > score_threshold
    center, size, heading, cls, score = center[ok], size[ok], heading[ok], cls[ok], score[ok]
    boxes7_all = np.concatenate([center, size, heading[:, None]], axis=1)
    keep = nms_3d_samecls(center, size, score, headings=heading, classes=cls, iou_threshold=nms_iou)
    boxes7 = np.concatenate([center[keep], size[keep], heading[keep, None]], axis=1)
    result = {
        "bboxes": boxes7_all, "scores": score, "classes": cls,
        "classes_nms": cls[keep], "bboxes_nms": boxes7, "scores_nms": score[keep],
    }
    np.savez_compressed(out_path, result)
    return result


def run_detection_inference(model, dataset, out_dir: str | Path, nms_iou: float = 0.25,
                            score_threshold: float = 0.05) -> int:
    """Per-split Group-Free inference (infer.py:153-226): one eval
    forward per scan of ``dataset`` on the model's device, then
    ``{out_dir}/{take}_{scan}.npz``. The next scan's load and forward are
    queued before the current scan's decode/NMS/write
    (:func:`~or4d_tpu_torch.utils.stream.lookahead`). Returns the number of
    files written."""
    from or4d_tpu_torch.utils.stream import lookahead

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    msa_np = np.asarray(dataset.mean_size_arr())
    msa = _mean_sizes(model, msa_np)
    model.eval()

    def dispatch(i):
        ret = dataset[i]
        decoded = _decoded(_forward(model, ret["point_clouds"], msa), msa_np)
        event = None
        if msa.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return ret["scan_name"], decoded, event

    def consume(item):
        name, decoded, event = item
        if event is not None:
            event.synchronize()
        _finish_boxes(decoded, out_dir / f"{name}.npz", nms_iou, score_threshold)
        return 1

    return sum(lookahead(range(len(dataset)), dispatch, consume))
