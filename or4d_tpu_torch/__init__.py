"""or4d_tpu_torch — the PyTorch/CUDA port of ``or4d_tpu`` for NVIDIA Hopper.

The JAX package ``or4d_tpu`` is the reference; this package keeps its module
names so counterparts are easy to find, and imports nothing of it (nor of
JAX). Plain tensor code is PyTorch; every Pallas kernel on a ported path is a
CUDA C++ kernel under ``ops/csrc`` built for ``sm_90a`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (:func:`resolve_device`). On
the CPU each kernel wrapper takes its plain PyTorch version; a CUDA tensor
always goes to the kernel.
"""

from or4d_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
