"""FPS's share of its roofline: the least time of one call's FPS launches
(rows 1 and 2), from the recorded calls, over their traced device time a
call, in percent."""

from harness.kernels import FPS


def read(o):
    bound = o.bounds_ms.get("fps")
    if o.trace is None or not bound:
        return None
    ms = 1e3 * o.trace.op_seconds(*FPS) / o.trace_calls
    return 100.0 * bound / ms if ms > 0 else None
