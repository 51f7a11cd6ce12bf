"""Paper-weight import: the reference's torch state_dict -> the port's SGPN
``state_dict`` (the port's counterpart of ``or4d_tpu/utils/torch_import.py``,
which maps the same layout onto flax variables).

The reference ships paper checkpoints (`paper_model_no_gt_no_images.pth`,
loaded with a raw load_state_dict at scene_graph_prediction/main.py:74-79).

Layout mapping (reference -> port):
  {enc}.backbone.SA_modules.{s}.mlps.{k}.{3*l}.weight      Conv2d (O, I, 1, 1)
      -> {enc}.sa{s+1}.mlp_{k}.dense_{l}.weight (O, I)     (s = 2: sa3.mlp)
  ...SA_modules.{s}.mlps.{k}.{3*l+1}.*                     BatchNorm2d
      -> ...bn_{l}.{weight,bias,running_mean,running_var}
  gcn.gconvs.{i}.nn1.{0,3} / nn2.{0,3}                     Linear
      -> gcn.layer_{i}.nn1.dense_{0,1} / nn2.dense_{0,1}
  gcn.gconvs.{i}.nn1.{1,4} / nn2.1                         BatchNorm1d
      -> ...nn1.bn_{0,1} / nn2.bn_0 (track_running_stats=False: affine only)
  obj_predictor.fc{1,2,3} / rel_predictor.fc{1,2,3}        Linear (same names)
  full_image_model.{timm key}                              timm tf_efficientnet_b5_ns
      -> image_branch.trunk.{efficientnet.timm_parameter_mapping()}
  full_image_feature_reduction.{weight,bias}               Linear
      -> image_branch.reduction.{weight,bias}

Keys of the model that the checkpoint does not carry keep the model's
values. A shape mismatch raises. Unmapped checkpoint keys other than the
wrapper's ``weights_*`` buffers and BN ``num_batches_tracked`` counters are
reported by a warning, as the JAX importer reports them (the image
branch's keys among them when the model has no image branch).
"""

from __future__ import annotations

import warnings
from collections.abc import Iterator, Mapping

import numpy as np
import torch

# gcn layer i: reference Sequential index -> port module
_GCN = {"nn1.0": "nn1.dense_0", "nn1.1": "nn1.bn_0", "nn1.3": "nn1.dense_1", "nn1.4": "nn1.bn_1",
        "nn2.0": "nn2.dense_0", "nn2.1": "nn2.bn_0", "nn2.3": "nn2.dense_1"}


def _key_pairs(port_keys) -> Iterator[tuple[str, str]]:
    """(reference key, port key) for every port state_dict key that has a
    reference counterpart."""
    for key in port_keys:
        parts = key.split(".")
        if parts[0] in ("obj_encoder", "rel_encoder") and parts[1] in ("sa1", "sa2", "sa3"):
            s = int(parts[1][2]) - 1
            k = 0 if parts[2] == "mlp" else int(parts[2].split("_")[1])
            kind, l = parts[3].split("_")
            idx = 3 * int(l) + (0 if kind == "dense" else 1)
            yield f"{parts[0]}.backbone.SA_modules.{s}.mlps.{k}.{idx}.{parts[4]}", key
        elif parts[0] == "gcn":
            i = int(parts[1].split("_")[1])
            sub = ".".join(parts[2:4])
            ref = next(r for r, p in _GCN.items() if p == sub)
            yield f"gcn.gconvs.{i}.{ref}.{parts[4]}", key
        elif parts[0] in ("obj_predictor", "rel_predictor"):
            yield key, key
        elif parts[0] == "image_branch" and parts[1] == "reduction":
            yield f"full_image_feature_reduction.{parts[2]}", key
        elif parts[0] == "image_branch":
            yield f"full_image_model.{_timm_keys()[key.split('.', 2)[2]]}", key


def _timm_keys() -> dict[str, str]:
    """The image trunk's state_dict keys -> timm's."""
    from or4d_tpu_torch.models.efficientnet import timm_parameter_mapping

    return {port: timm for timm, port in timm_parameter_mapping()}


def _to_np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def import_reference_state_dict(state_dict: Mapping, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The ``state_dict`` of ``model`` with every leaf the reference
    checkpoint ``state_dict`` carries replaced by it (float32, on the model's
    device). Load the result with ``model.load_state_dict``."""
    out = dict(model.state_dict())
    handled = set()
    for ref, key in _key_pairs(list(out)):
        if ref not in state_dict:
            continue
        w = _to_np(state_dict[ref])
        if w.ndim == 4 and ".SA_modules." in ref:  # Conv2d 1x1 (O, I, 1, 1)
            w = w.reshape(w.shape[0], -1)
        want = out[key]
        if tuple(w.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint {ref} {tuple(w.shape)} vs model {tuple(want.shape)}")
        out[key] = torch.as_tensor(np.ascontiguousarray(w), dtype=want.dtype).to(want.device)
        handled.add(ref)
    unused = [k for k in state_dict if k not in handled
              and not (k.startswith("weights_") or k.endswith("num_batches_tracked"))]
    if unused:
        warnings.warn(
            f"import_reference_state_dict: {len(unused)} reference keys were NOT mapped "
            f"(trained state dropped!): {unused[:10]}{'...' if len(unused) > 10 else ''}"
        )
    return out


def export_reference_state_dict(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The inverse mapping: ``model``'s weights in the reference checkpoint
    layout (SA convolutions as (O, I, 1, 1)), on the CPU."""
    sd = model.state_dict()
    out = {}
    for ref, key in _key_pairs(list(sd)):
        t = sd[key].detach().cpu()
        if ".SA_modules." in ref and ref.endswith(".weight") and t.dim() == 2:
            t = t[:, :, None, None]
        out[ref] = t.clone()
    return out


def load_reference_checkpoint(path, model: torch.nn.Module) -> None:
    """Load a reference ``.pth`` (a raw state_dict, or a Lightning ``.ckpt``
    dict wrapping one under ``state_dict``) into ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model.load_state_dict(import_reference_state_dict(sd, model))

