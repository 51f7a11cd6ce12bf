"""The program under test, as the benchmark drives it: the port's trainer
built for a cell and loaded with the benchmark's weights, and the port's
batch type filled with the benchmark's scenes. Nothing else of the program
is used but the spans and counters the drivers wrap and read."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def port_config(cell):
    """The port's ExperimentConfig for the cell: the configuration file as
    the port's loader reads it, the encoder geometry and frame size from the
    file's blocks, and the traffic's batch, precision and padding."""
    from or4d_tpu_torch.config import ExperimentConfig, TPUConfig

    raw = dict(cell.config)
    cfg = ExperimentConfig.from_reference_json(raw, name=raw.get("NAME"))
    pn = raw["pointnet2_msg"]
    model = dataclasses.replace(
        cfg.model,
        sa_npoints=(pn["sa1"]["npoint"], pn["sa2"]["npoint"]),
        sa_nsamples=(tuple(pn["sa1"]["nsamples"]), tuple(pn["sa2"]["nsamples"])),
        image_size=raw.get("image", {}).get("size", cfg.model.image_size),
    )
    tr = cell.traffic
    ds = dataclasses.replace(cfg.dataset, max_objects=tr["max_objects"], max_edges=tr["max_edges"])
    tpu = TPUConfig(scene_batch=tr["scenes_per_batch"], compute_dtype=tr["dtype"])
    return dataclasses.replace(cfg, model=model, dataset=ds, tpu=tpu)


def scene_batch(arrays: dict, images=None):
    """The port's SceneBatch of host arrays (``harness.scenes.make_batch``)."""
    from or4d_tpu_torch.data.scene_batch import SceneBatch

    keys = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask",
            "edge_mask", "rel_hand_points")
    return SceneBatch(**{k: arrays[k] for k in keys}, images=images, scan_ids=arrays["scan_ids"],
                      take_idxs=arrays["take_idxs"], slot_names=arrays["slot_names"])


def trainer(cell, params: dict, w_obj: torch.Tensor, w_rel: torch.Tensor, device):
    """The port's Trainer for the cell with every state_dict entry replaced
    by the benchmark's tensors (a strict load: a name or shape the port does
    not have fails)."""
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.train.loop import Trainer

    t = Trainer(port_config(cell), DEFAULT_VOCAB, w_obj.cpu().numpy().astype(np.float32),
                w_rel.cpu().numpy().astype(np.float32), device=device)
    t.model.load_state_dict(params, strict=True)
    return t


class Capture:
    """Keeps each forward's log-probs (and the image branch's embedding) as
    the program returned them, by a forward hook: the timed path's own
    outputs, on the device."""

    def __init__(self, model):
        self.calls: list[dict] = []
        self.tag = None
        self._emb = None
        self._hooks = [model.register_forward_hook(self._out)]
        if getattr(model, "use_image", False):
            self._hooks.append(model.image_branch.register_forward_hook(self._image))

    def _image(self, _m, _args, out):
        self._emb = out.detach()

    def _out(self, _m, _args, out):
        self.calls.append({"tag": self.tag, "rel": out.rel_logprobs.detach(), "obj": out.obj_logprobs.detach(),
                           "emb": self._emb})
        self._emb = None

    def close(self):
        for h in self._hooks:
            h.remove()
        self._hooks = []
