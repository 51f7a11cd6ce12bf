"""Device ms of host-to-device copies a served batch takes (the offloaded
SA1 caches' upload), from the profiled evaluation."""


def read(o):
    if o.trace is None or not o.trace_batches:
        return None
    s = o.trace.op_seconds("HtoD")
    return 1e3 * s / o.trace_batches if s > 0 else None
