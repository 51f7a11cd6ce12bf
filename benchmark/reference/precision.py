"""The arithmetic of the reference's products.

``f32``: float32 throughout, TF32 off (the judge). ``tf32``: cuBLAS and
cuDNN allowed TF32, the step below float32 with TF32 off. ``fp8``: both
operands of every product rounded to float8 e4m3 with a per-tensor scale
(amax to 448), the step below bfloat16. Geometry (FPS, the ball query, the
offsets p - q) stays float32 in every mode: only the products' operands
are rounded.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or float(amax) == 0.0:
        return x
    s = _E4M3_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class Precision:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision mode {mode!r} not in {MODES}")
        self.mode = mode

    def _ops(self, *ts):
        return tuple(fp8_round(t) if self.mode == "fp8" else t for t in ts)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        x, w = self._ops(x.float(), w.float())
        return F.linear(x, w, b)

    def conv2d(self, x, w, b=None, stride: int = 1, groups: int = 1) -> torch.Tensor:
        x, w = self._ops(x, w)
        return F.conv2d(x, w, b, stride, 0, 1, groups)

    @contextlib.contextmanager
    def flags(self):
        """TF32 on for ``tf32``, off otherwise, for the block."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
