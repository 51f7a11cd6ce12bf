"""The 90th percentile (nearest rank) of the host time of every entry call
in the window: one batch from its host arrays to its relations. At the
run's length a window holds some 100 calls of ~0.5 s, so ten or so lie
beyond it."""

import math


def read(o):
    if not o.call_ms:
        return None
    ms = sorted(o.call_ms)
    return ms[math.ceil(0.9 * len(ms)) - 1]
