"""Device ms per step of PyTorch's own elementwise and reduction kernels
(the masked BN/ReLU chain, the optimizer), from the profiled steps."""


def read(o):
    if o.trace is None or not o.trace_calls:
        return None
    s = o.trace.op_seconds("elementwise_kernel", "reduce_kernel")
    return 1e3 * s / o.trace_calls if s > 0 else None
