"""The program's kernels as the benchmark sees them: their names in a device
trace, the launch counters that must agree with a trace, and the recorded
calls whose least times (``harness.bounds``) the roofline readers divide by
the traced times.

``Recorder`` is ``chip_smoke.py``'s (copied): it wraps the kernel entry
points the encoders call and keeps each call's arguments (tensors on the
card) while on.
"""

from __future__ import annotations

from harness import bounds

FPS = ("fps_kernel", "fps_cluster_kernel")
SA_TILE = ("sa_mma_kernel", "sa_fp32_kernel", "serving_mma_kernel", "serving_fp32_kernel")
GROUPING = ("group_fwd_kernel", "group_raw_bwd_partial", "group_raw_bwd_reduce", "group_bwd_build", "group_bwd_sum")
# launch counters (``or4d_tpu_torch.ops.launch_counts``) -> the kernels they launch once a count
_COUNTED = (
    (lambda k: k.startswith("fps."), FPS),
    (lambda k: k.startswith("sa_group_mlp."), SA_TILE[:2]),
    (lambda k: k.startswith("serving_sa1."), SA_TILE[2:]),
    (lambda k: k.startswith("group") and k.endswith(".fwd"), ("group_fwd_kernel",)),
    (lambda k: k.startswith("ball_query."), ("ball_query_multiscale_kernel",)),
)


def trace_holds_counted(trace, rose: dict) -> bool:
    """Whether the trace has at least as many of each kernel as its launch
    counters rose in the traced run."""
    for pred, names in _COUNTED:
        counted = sum(v for k, v in rose.items() if pred(k))
        if counted and trace.op_count(*names) < counted:
            return False
    return True


class Recorder:
    NAMES = ("furthest_point_sample", "furthest_point_sample_with_bounds", "sa_group_mlp", "ball_query_group",
             "ball_query_group_gated", "ball_query_group_raw", "serving_sa1_mlp")

    def __init__(self):
        from or4d_tpu_torch.models import pointnet2

        self.mod = pointnet2
        self.orig = {n: getattr(pointnet2, n) for n in self.NAMES}
        self.calls: list = []

    def _wrap(self, name):
        fn = self.orig[name]

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((name, tuple(a.detach() if hasattr(a, "detach") else a for a in args),
                               {k: v.detach() if hasattr(v, "detach") else v for k, v in kw.items()}))
            return out

        return wrapped

    def record(self, run) -> list:
        self.calls = []
        for n in self.NAMES:
            setattr(self.mod, n, self._wrap(n))
        try:
            run()
        finally:
            for n in self.NAMES:
                setattr(self.mod, n, self.orig[n])
        calls, self.calls = self.calls, []
        return calls


def bounds_ms(calls) -> dict[str, float]:
    """Least ms of one recorded call's kernels, by family: ``fps`` (rows 1
    and 2), ``sa_tile`` (rows 3, 4 and 7), ``grouping`` (the train step's
    FPS and grouping forward and backward: rows 1, 2, 5, 6 and 9)."""
    out = {"fps": 0.0, "sa_tile": 0.0, "grouping": 0.0}
    for name, args, kw in calls:
        if name == "furthest_point_sample":
            ms = bounds.fps_bound(args[0], args[1])[0]
            out["fps"] += ms
            out["grouping"] += ms
        elif name == "furthest_point_sample_with_bounds":
            ms = bounds.fps_bound(args[0], args[1], args[2])[0]
            out["fps"] += ms
            out["grouping"] += ms
        elif name == "sa_group_mlp":
            out["sa_tile"] += bounds.sa_group_mlp_bound(args, kw)[0]
        elif name == "serving_sa1_mlp":
            out["sa_tile"] += bounds.serving_sa1_bound(args)[0]
        else:
            fwd, bwd = bounds.grouping_bounds(name, args)
            out["grouping"] += fwd[0] + bwd[0]
    return {k: v for k, v in out.items() if v > 0}
