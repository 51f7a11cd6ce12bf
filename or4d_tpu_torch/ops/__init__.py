"""Point-cloud ops of the port: FPS, the fused eval SA stage, the train
grouping with its backward (plane mode, plane mode with the FPS bound, raw
mode), the serving path's multi-scale ball query and SA1 MLP on cached
planes, and the bounds pre-pass (each a CUDA kernel beside its plain
PyTorch version), and the plain index ball query; ``interpolate`` (3-NN),
``grouping`` (the public gathers and QueryAndGroup / GroupAll), ``scatter``
(segment sum / max / mean) and ``box_geometry`` (oriented boxes, NMS) are
plain PyTorch and numpy.

Every kernel wrapper counts its launches in its module's ``LAUNCHES`` dict
(``ball_query_group_gated`` in ``ball_query_group.LAUNCHES_GATED``);
:func:`launch_counts` and :func:`reset_launch_counts` read and zero them all,
so a run can show that a path went through the kernels.
"""

from or4d_tpu_torch.ops import (ball_query_bounds, ball_query_group, ball_query_group_raw, ball_query_multiscale,
                                fps, sa_group_mlp, serving_sa1_mlp)
from or4d_tpu_torch.ops.floyd_warshall import gen_edge_input
from or4d_tpu_torch.ops.fps import furthest_point_sample
from or4d_tpu_torch.ops.grouping import gather_points, group_all, grouping_operation, query_and_group
from or4d_tpu_torch.ops.interpolate import three_interpolate, three_nn
from or4d_tpu_torch.ops.scatter import segment_max, segment_mean, segment_sum

# the public ops, as or4d_tpu/ops/__init__.py:21-37 exports them, but for
# ball_query and floyd_warshall: those names stay the submodules here
# (ops.ball_query.ball_query, ops.floyd_warshall.floyd_warshall)
__all__ = [
    "furthest_point_sample",
    "gather_points",
    "grouping_operation",
    "query_and_group",
    "group_all",
    "three_nn",
    "three_interpolate",
    "segment_sum",
    "segment_max",
    "segment_mean",
    "gen_edge_input",
    "launch_counts",
    "reset_launch_counts",
]

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
