"""The fused SA tiles' share of their roofline: the least time of one call's
fused eval SA stages (rows 3 and 4) and serving SA1 MLPs (row 7), from the
recorded calls (``harness.bounds``), over their traced device time a call,
in percent."""

from harness.kernels import SA_TILE


def read(o):
    bound = o.bounds_ms.get("sa_tile")
    if o.trace is None or not bound:
        return None
    ms = 1e3 * o.trace.op_seconds(*SA_TILE) / o.trace_calls
    return 100.0 * bound / ms if ms > 0 else None
