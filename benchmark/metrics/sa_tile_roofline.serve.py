"""The serving tiles' share of their roofline: the least time of one
evaluation's serving SA1 MLPs (row 7) and fused SA2 stages (row 4), from
the recorded calls (``harness.bounds``), over their traced device time an
evaluation, in percent."""

from harness.kernels import SA_TILE


def read(o):
    bound = o.bounds_ms.get("sa_tile")
    if o.trace is None or not bound:
        return None
    ms = 1e3 * o.trace.op_seconds(*SA_TILE) / o.trace_calls
    return 100.0 * bound / ms if ms > 0 else None
