"""Device resolution for the port's entry points.

Entry points default to the card. Asking for ``cuda`` (explicitly or by
default) on a machine without one raises: nothing silently carries on on the
CPU. The CPU is used only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and none
    is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "or4d_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev
