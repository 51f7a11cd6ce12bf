"""The window's share of the chip's peak: the published model's operations
on the batches' valid slots (``harness.flops``) times the calls, over the
traced run's window time and the peak of the cell's type (989 TFLOP/s in
bfloat16, 67 in float32), in percent."""

from harness.flops import mfu_percent


def read(o):
    return mfu_percent(o.flops_per_call, o.calls, o.window_s, o.dtype)
