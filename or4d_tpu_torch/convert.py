"""Carry the JAX package's SGPN and Graphormer variables over to the port.

``from_jax_variables(variables, model)`` maps the flax tree
({"params": ..., "batch_stats": ...}, leaves as numpy arrays) onto the
port's ``state_dict`` names: module paths are the same
(``obj_encoder/sa1/mlp_0/dense_0`` -> ``obj_encoder.sa1.mlp_0.dense_0``);
a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), a convolution's
(k, k, in, out) (the image branch's; depthwise (k, k, 1, C)) becomes
(out, in, k, k); a norm's
``scale``/``bias`` become ``weight``/``bias``; ``batch_stats`` ``mean``/``var``
become ``running_mean``/``running_var``. Missing or extra keys and shape
mismatches raise. ``graphormer_from_jax_params(params, model)`` does the
same for the role-prediction Graphormer, and
``groupfree_from_jax_variables(variables, model)`` for the Group-Free
detector (flax attention's per-head kernels flattened to the port's Dense
layout), and ``higherhrnet_from_jax_variables`` /
``voxelpose_from_jax_variables`` for the pose models (convolution kernels
(*k, in, out) -> (out, in, *k); a transposed convolution's -> (in, out, *k)
flipped in every spatial axis, since flax's ``ConvTranspose`` does not flip
its kernel and ``F.conv_transpose{2,3}d`` does).
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
    return _matched(out, model)


def _matched(out: dict[str, torch.Tensor], model: nn.Module) -> dict[str, torch.Tensor]:
    """``out`` checked against ``model``'s state_dict (the same keys and
    shapes) and moved to its tensors' devices and dtypes."""
    expected = model.state_dict()
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


# the Graphormer's parameters that are neither a Dense, an Embed nor a LayerNorm
_GRAPHORMER_RAW = ("edge_dis_encoder", "graph_token", "graph_token_virtual_distance")
_GRAPHORMER_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def graphormer_from_jax_params(params: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of the port's ``Graphormer`` from the flax parameter
    tree of ``or4d_tpu.models.graphormer.Graphormer``: Dense kernels
    transposed, Embed ``embedding`` and LayerNorm ``scale`` become
    ``weight``, the raw parameters carry across. Missing or extra keys and
    shape mismatches raise."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if len(path) == 1 and path[0] in _GRAPHORMER_RAW:
            key = path[0]
        elif path[-1] in _GRAPHORMER_LEAF:
            key = ".".join(path[:-1] + (_GRAPHORMER_LEAF[path[-1]],))
            if path[-1] == "kernel":
                arr = arr.T
        else:
            raise KeyError(f"unknown leaf {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return _matched(out, model)


# the flax MultiHeadDotProductAttention projections of the Group-Free decoder
_ATTENTION = ("self_attn", "cross_attn")


def _flat_attention(path: tuple, arr: np.ndarray) -> np.ndarray:
    """A flax attention leaf in the 2D layout of a Dense: query/key/value
    kernels (in, heads, d) -> (in, heads * d), their biases (heads, d) ->
    (heads * d,), the out kernel (heads, d, out) -> (heads * d, out)."""
    if len(path) < 3 or path[-3] not in _ATTENTION:
        return arr
    proj, leaf = path[-2], path[-1]
    if leaf == "kernel":
        return arr.reshape(arr.shape[0] * arr.shape[1], -1) if proj == "out" else arr.reshape(arr.shape[0], -1)
    return arr if proj == "out" else arr.reshape(-1)


def groupfree_from_jax_variables(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of the port's ``GroupFreeDetector`` from the flax
    variables of ``or4d_tpu.models.groupfree.GroupFreeDetector``: Dense
    kernels transposed, attention kernels flattened first
    (:func:`_flat_attention`), LayerNorm ``scale`` -> ``weight``,
    ``batch_stats`` -> running statistics. Missing or extra keys and shape
    mismatches raise."""
    flat = {}
    for collection in ("params", "batch_stats"):
        tree: dict = {}
        for path, leaf in _flatten(variables.get(collection, {})):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _flat_attention(path, np.array(leaf, dtype=np.float32))  # a writable copy
        flat[collection] = tree
    return from_jax_variables(flat, model)


def _conv_from_jax_variables(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of a model of ``ConvNd`` and ``FlaxBatchNorm`` layers
    whose module paths are the flax tree's, in the model's own dtype (a
    float64 copy of a model takes float64 leaves at full precision)."""
    from or4d_tpu_torch.models.layers import ConvNd

    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            name = _LEAF.get((collection, path[-1]))
            if name is None:
                raise KeyError(f"unknown leaf {collection}/{'/'.join(path)}")
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                conv = model.get_submodule(".".join(path[:-1]))
                if not isinstance(conv, ConvNd):
                    raise KeyError(f"{'/'.join(path)}: not a convolution in the model")
                nd = arr.ndim - 2
                spatial = tuple(range(nd))
                if conv.transpose:
                    arr = np.flip(arr.transpose((nd, nd + 1) + spatial), axis=tuple(range(2, nd + 2)))
                else:
                    arr = arr.transpose((nd + 1, nd) + spatial)
            out[".".join(path[:-1] + (name,))] = torch.from_numpy(np.ascontiguousarray(arr))
    return _matched(out, model)


def higherhrnet_from_jax_variables(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of the port's ``HigherHRNet`` from the flax variables
    of ``or4d_tpu.models.higherhrnet.HigherHRNet``. Missing or extra keys
    and shape mismatches raise."""
    return _conv_from_jax_variables(variables, model)


def voxelpose_from_jax_variables(variables: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """The state_dict of the port's ``VoxelPose`` from the flax variables of
    ``or4d_tpu.models.voxelpose.VoxelPose``. Missing or extra keys and shape
    mismatches raise."""
    return _conv_from_jax_variables(variables, model)
