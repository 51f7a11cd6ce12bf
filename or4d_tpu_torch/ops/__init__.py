"""Point-cloud ops of the port: FPS, the fused eval SA stage, the train
grouping with its backward (plane mode, plane mode with the FPS bound, raw
mode), the serving path's multi-scale ball query and SA1 MLP on cached
planes, and the bounds pre-pass (each a CUDA kernel beside its plain
PyTorch version), and the plain index ball query; ``interpolate`` (3-NN)
and ``box_geometry`` (oriented boxes, NMS) are plain PyTorch and numpy.

Every kernel wrapper counts its launches in its module's ``LAUNCHES`` dict
(``ball_query_group_gated`` in ``ball_query_group.LAUNCHES_GATED``);
:func:`launch_counts` and :func:`reset_launch_counts` read and zero them all,
so a run can show that a path went through the kernels.
"""

from or4d_tpu_torch.ops import (ball_query_bounds, ball_query_group, ball_query_group_raw, ball_query_multiscale,
                                fps, sa_group_mlp, serving_sa1_mlp)

_COUNTERS = {"fps": fps.LAUNCHES, "sa_group_mlp": sa_group_mlp.LAUNCHES,
             "group": ball_query_group.LAUNCHES, "group_gated": ball_query_group.LAUNCHES_GATED,
             "group_raw": ball_query_group_raw.LAUNCHES,
             "ball_query": ball_query_multiscale.LAUNCHES, "serving_sa1": serving_sa1_mlp.LAUNCHES,
             "bounds": ball_query_bounds.LAUNCHES}


def launch_counts() -> dict[str, int]:
    """{"fps.fps": n, "fps.fps_counts": n, "sa_group_mlp.raw": n, ...}"""
    return {f"{mod}.{k}": v for mod, d in _COUNTERS.items() for k, v in d.items()}


def reset_launch_counts() -> None:
    for d in _COUNTERS.values():
        for k in d:
            d[k] = 0
