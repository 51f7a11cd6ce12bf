"""The serving window's share of the chip's peak: the published model's
operations on every served batch's valid slots (``harness.flops``) times
the evaluations, over the traced run's window time and the peak of the
cell's type (989 TFLOP/s in bfloat16), in percent."""

from harness.flops import mfu_percent


def read(o):
    return mfu_percent(o.flops_per_call, o.calls, o.window_s, o.dtype)
