"""L1 inference: Group-Free detection to the box npz files L2 reads
(port of the detection half of ``or4d_tpu/pipeline/perception_infer.py``).

Reference: `group_free_3D/OR_4D/infer.py:153-226` and
`ap_helper.dump_predictions` (:263-322): per scan one
``group_free_predictions/{take}_{scan}.npz`` holding a pickled dict under
``arr_0`` with the confidence-filtered boxes (``bboxes`` (K, 7) as center,
size, heading; ``scores``; ``classes``) and the same after same-class NMS
(``*_nms``, what ``compute_instance_labels`` consumes). The file is read
back with :func:`~or4d_tpu_torch.pipeline.instance_labels.load_boxes_npz`.

The 2D and 3D pose inference of the JAX module comes with its models
(ROADMAP Queue 1 item 5b).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


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
