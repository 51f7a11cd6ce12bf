"""The window's share of the chip's peak in training: the published model's
forward and the backward the step needs (``harness.flops``) times the
steps, over the traced run's window time and the peak of the cell's type,
in percent."""

from harness.flops import mfu_percent


def read(o):
    return mfu_percent(o.flops_per_call, o.calls, o.window_s, o.dtype)
