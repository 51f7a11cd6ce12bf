"""A cell's inputs, made from the seed: its batches of scenes (with camera
frames where the configuration has an image branch), the weights, the loss
weights, and the program's trainer loaded with them."""

from __future__ import annotations

import torch

from harness import program, scenes, weights
from reference import efficientnet as ref_b5, sgpn as ref_sgpn

DEVICE_FIELDS = ("obj_points", "rel_points", "edge_index", "rel_onehot", "gt_class", "gt_rels", "obj_mask",
                 "edge_mask", "rel_hand_points")


def shapes(cell) -> scenes.Shapes:
    tr, ds = cell.traffic, cell.config["dataset"]
    return scenes.Shapes(tr["objects_per_scene"], tr["points_per_object"], tr["max_objects"], tr["max_edges"],
                         ds["num_points_objects"], ds["num_points_relation"], tr["pair_shared"])


def has_image(cfg: dict) -> bool:
    return cfg.get("IMAGE_INPUT") == "full"


def param_specs(cfg: dict):
    return ref_sgpn.param_specs(cfg) + (ref_b5.param_specs(cfg) if has_image(cfg) else [])


def frames(run, i: int, S: int):
    """Batch ``i``'s camera frames (S, cameras, H, W, 3), standard normal
    (as the transform's normalised output), drawn on the device, on the host."""
    im = run.cell.config["image"]
    g = weights.generator(run.seed, f"frames{i}", run.device)
    shape = (S, im["cameras"], im["size"], im["size"], 3)
    return torch.randn(shape, generator=g, device=run.device).cpu().numpy()


def make_inputs(run, n: int, S: int):
    """``n`` batches of ``S`` different scenes, and their frames (or None)."""
    cfg = run.cell.config
    arrays = [scenes.make_batch(run.seed, range(i * S, (i + 1) * S), shapes(run.cell), run.device)
              for i in range(n)]
    images = [frames(run, i, S) if has_image(cfg) else None for i in range(n)]
    return arrays, images


def to_device(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(arrays[k]).to(device) for k in DEVICE_FIELDS}


def valid_counts(arrays: dict) -> tuple[int, int]:
    """(valid objects, valid directed edges) of a batch."""
    return int(arrays["obj_mask"].sum()), int(arrays["edge_mask"].sum())


def make_trainer(run):
    cfg = run.cell.config
    P = weights.make_params(param_specs(cfg), run.seed, run.device)
    w_obj = weights.class_weights(run.seed, cfg["classes"], "w_obj", run.device)
    w_rel = weights.class_weights(run.seed, cfg["relations"], "w_rel", run.device)
    run.log("weights made")
    tr = program.trainer(run.cell, P, w_obj, w_rel, run.device)
    del P
    return tr
