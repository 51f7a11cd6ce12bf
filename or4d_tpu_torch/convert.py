"""Carry the JAX package's SGPN variables over to the port.

``from_jax_variables(variables, model)`` maps the flax tree
({"params": ..., "batch_stats": ...}, leaves as numpy arrays) onto the
port's ``state_dict`` names: module paths are the same
(``obj_encoder/sa1/mlp_0/dense_0`` -> ``obj_encoder.sa1.mlp_0.dense_0``);
a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), a convolution's
(k, k, in, out) (the image branch's; depthwise (k, k, 1, C)) becomes
(out, in, k, k); a norm's
``scale``/``bias`` become ``weight``/``bias``; ``batch_stats`` ``mean``/``var``
become ``running_mean``/``running_var``. Missing or extra keys and shape
mismatches raise.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight", ("params", "bias"): "bias",
         ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_variables(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of ``model`` built from the JAX variables; load it with
    ``model.load_state_dict``. Tensors are float32 on the model's device."""
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            name = _LEAF.get((collection, path[-1]))
            if name is None:
                raise KeyError(f"unknown leaf {collection}/{'/'.join(path)}")
            key = ".".join(path[:-1] + (name,))
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            if key in out:
                raise KeyError(f"duplicate key {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(expected) - set(out))
    extra = sorted(set(out) - set(expected))
    if missing or extra:
        raise KeyError(f"JAX variables do not match the model: missing {missing}, extra {extra}")
    for key, t in out.items():
        ref = expected[key]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {tuple(t.shape)} vs model {tuple(ref.shape)}")
        out[key] = t.to(device=ref.device, dtype=ref.dtype)
    return out
