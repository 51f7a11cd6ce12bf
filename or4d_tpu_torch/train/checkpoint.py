"""Checkpoint / resume with ``torch.save`` (the JAX package uses orbax,
``or4d_tpu/train/checkpoint.py``): one file per step holding the model's
state_dict (parameters and BN running statistics), the optimizer's
state_dict and the step. Loading reads tensors and plain containers only
(``weights_only=True``).
"""

from __future__ import annotations

import re
from pathlib import Path

import torch

_NAME = "step_{:08d}.pt"
_PATTERN = re.compile(r"step_(\d{8})\.pt$")


def save(directory: str | Path, model: torch.nn.Module, optimizer: torch.optim.Optimizer, step: int) -> Path:
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    out = path / _NAME.format(step)
    tmp = out.with_suffix(".tmp")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": int(step)}, tmp)
    tmp.replace(out)
    return out


def latest_step(directory: str | Path) -> int | None:
    """The largest saved step under ``directory``, or None."""
    path = Path(directory)
    if not path.is_dir():
        return None
    steps = [int(m.group(1)) for p in path.iterdir() if (m := _PATTERN.search(p.name))]
    return max(steps) if steps else None


def restore(directory: str | Path, model: torch.nn.Module, optimizer: torch.optim.Optimizer | None = None) -> int:
    """Load the latest saved step into ``model`` and ``optimizer``, each on
    its own device; returns the step."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    dev = next(model.parameters()).device
    state = torch.load(Path(directory) / _NAME.format(step), map_location=dev, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])
