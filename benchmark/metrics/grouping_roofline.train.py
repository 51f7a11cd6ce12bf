"""The train step's own kernels' share of their roofline: the least time of
one step's FPS (rows 1 and 2) and train grouping forwards and backwards
(rows 5 and 6, or 9), from the recorded step, over their traced device time
a step, in percent."""

from harness.kernels import FPS, GROUPING


def read(o):
    bound = o.bounds_ms.get("grouping")
    if o.trace is None or not bound:
        return None
    ms = 1e3 * o.trace.op_seconds(*FPS, *GROUPING) / o.trace_calls
    return 100.0 * bound / ms if ms > 0 else None
