"""Graphormer role-prediction inputs: scene-graph tracks -> padded
``GraphormerBatch`` tensors (port of ``or4d_tpu/pipeline/role_graphormer.py``).

Host-side preprocessing of the reference chain:
  * star expansion of scene graphs: each (sub, rel, obj) triplet becomes a
    relation node `$_{rel}_{idx}` with two edges
    (role_prediction_dataset.py:203-214), node vocab of 22 ids (:121-151),
    the tracked human renamed TARGET;
  * `preprocess_item` (graphormer/wrapper.py:23-56): +1 id offset
    (convert_to_single_emb), adjacency, attn_edge_type = edge_attr + 2,
    Floyd-Warshall spatial positions, multi-hop edge input, degrees;
  * the collator's +1 pad offsets, masking beyond spatial_pos_max, and
    one-track-is-one-batch layout (collator.py:94-148).

Shapes are padded (G graphs x 64 nodes), so a whole track is one forward.
The tensors are made on the CPU; ``GraphormerBatch.to`` moves them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from or4d_tpu_torch.models.graphormer import NEG_INF, GraphormerBatch
from or4d_tpu_torch.ops.floyd_warshall import floyd_warshall, gen_edge_input

MAX_NODE = 64  # reference data.py:32
MULTI_HOP_MAX_DIST = 5  # README command --multi_hop_max_dist 5
SPATIAL_POS_MAX = 16  # README command --spatial_pos_max 16 (training)

NODE_VOCAB = {
    "anesthesia_equipment": 1, "operating_table": 2, "instrument_table": 3,
    "secondary_table": 4, "instrument": 5, "object": 6, "human": 7, "TARGET": 8,
    "assisting": 9, "cementing": 10, "cleaning": 11, "closeto": 12, "cutting": 13,
    "drilling": 14, "hammering": 15, "holding": 16, "lyingon": 17, "operating": 18,
    "preparing": 19, "sawing": 20, "suturing": 21, "touching": 22,
}

ROLE_TO_INDEX = {"Patient": 0, "head-surgeon": 1, "assistant-surgeon": 2, "circulating-nurse": 3, "anaesthetist": 4}


def node_name_to_id(name: str) -> int:
    """role_prediction_dataset.objname_to_index semantics (:121-151)."""
    if "human" in name or "Patient" in name:
        name = "human"
    elif "$" in name:
        name = name.split("_")[1].lower()
    return NODE_VOCAB[name]


@dataclasses.dataclass
class StarGraph:
    """One scene graph star-expanded: every relation is its own node."""

    node_ids: np.ndarray  # (n,) int
    edge_index: np.ndarray  # (m, 2) int
    is_target: np.ndarray  # (n,) bool


def star_expand(relations: list, target_name: str | None = None) -> StarGraph | None:
    """[(sub, rel, obj), ...] -> star graph; None when empty (the reference
    skips empty graphs, role_prediction_dataset.py:216)."""
    if not relations:
        return None
    rels = [list(r) for r in relations]
    if target_name is not None:
        for r in rels:
            if r[0] == target_name:
                r[0] = "TARGET"
            if r[2] == target_name:
                r[2] = "TARGET"
    nodes: set[str] = set()
    for idx, (sub, rel, obj) in enumerate(rels):
        nodes.update((sub, obj, f"$_{rel}_{idx}"))
    ordered = sorted(nodes)
    edges = []
    for idx, (sub, rel, obj) in enumerate(rels):
        rname = f"$_{rel}_{idx}"
        edges.append((ordered.index(sub), ordered.index(rname)))
        edges.append((ordered.index(rname), ordered.index(obj)))
    return StarGraph(
        node_ids=np.array([node_name_to_id(n) for n in ordered], np.int64),
        edge_index=np.array(edges, np.int64),
        is_target=np.array([n == "TARGET" for n in ordered], bool),
    )


def preprocess_graph(g: StarGraph) -> dict:
    """graphormer/wrapper.py:23-56 on one star graph (numpy arrays out)."""
    n = len(g.node_ids)
    x = g.node_ids + 1  # convert_to_single_emb offset
    adj = np.zeros((n, n), bool)
    adj[g.edge_index[:, 0], g.edge_index[:, 1]] = True
    attn_edge_type = np.zeros((n, n), np.int64)
    # edge_attr is always 1 (role_prediction_dataset.py:222); +1 (conv) +1 = 3
    attn_edge_type[g.edge_index[:, 0], g.edge_index[:, 1]] = 1 + 1 + 1
    M, path = (t.numpy() for t in floyd_warshall(torch.from_numpy(adj)))
    max_dist = int(M.max()) if n else 0
    edge_input = gen_edge_input(max_dist, path, attn_edge_type[..., None])[..., 0]
    return {
        "x": x,
        "adj": adj,
        "attn_edge_type": attn_edge_type,
        "spatial_pos": M,
        "in_degree": adj.sum(axis=1).astype(np.int64),
        "out_degree": adj.sum(axis=0).astype(np.int64),
        "edge_input": edge_input,  # (n, n, max_dist), -1 = unwritten
        "is_target": g.is_target,
    }


def collate_track(graphs: list[dict], max_graphs: int | None = None, max_node: int = MAX_NODE,
                  multi_hop_max_dist: int = MULTI_HOP_MAX_DIST,
                  spatial_pos_max: int = SPATIAL_POS_MAX) -> GraphormerBatch:
    """Pad a track's preprocessed graphs into one GraphormerBatch
    (collator.py:94-148 semantics): graphs over ``max_node`` nodes are
    dropped, the track is cut to ``max_graphs`` and absent graphs padded."""
    graphs = [g for g in graphs if g is not None and len(g["x"]) <= max_node]
    G = max_graphs or len(graphs)
    N = max_node
    D = multi_hop_max_dist
    x = np.zeros((G, N), np.int32)
    attn_bias = np.zeros((G, N + 1, N + 1), np.float32)
    spatial_pos = np.zeros((G, N, N), np.int32)
    in_degree = np.zeros((G, N), np.int32)
    out_degree = np.zeros((G, N), np.int32)
    edge_input = np.zeros((G, N, N, D), np.int32)
    is_target = np.zeros((G, N), np.int32)

    for gi, g in enumerate(graphs[:G]):
        n = len(g["x"])
        x[gi, :n] = g["x"] + 1  # pad offset
        sp = g["spatial_pos"]
        bias = attn_bias[gi]
        bias[: n + 1, n + 1:] = NEG_INF
        bias[n + 1:, n + 1:] = NEG_INF
        bias[1: n + 1, 1: n + 1][sp >= spatial_pos_max] = NEG_INF
        spatial_pos[gi, :n, :n] = sp + 1
        in_degree[gi, :n] = np.clip(g["in_degree"] + 1, 0, 63)
        out_degree[gi, :n] = np.clip(g["out_degree"] + 1, 0, 63)
        d = min(D, g["edge_input"].shape[-1])
        edge_input[gi, :n, :n, :d] = g["edge_input"][:, :, :d] + 1
        is_target[gi, :n] = g["is_target"].astype(np.int32) + 1
    for gi in range(len(graphs), G):
        # wholly absent graphs: node<->node attention blocked, the virtual
        # token's row kept finite so the softmax stays defined
        attn_bias[gi, :, 1:] = NEG_INF
    arrays = dict(x=x, attn_bias=attn_bias, spatial_pos=spatial_pos, in_degree=in_degree, out_degree=out_degree,
                  edge_input=edge_input, is_target=is_target)
    return GraphormerBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def track_to_batch(track_relations: list[list], target_names: list[str | None],
                   max_graphs: int | None = None) -> GraphormerBatch:
    """Full chain for one track: per-frame scene graphs + the tracked human's
    per-frame name -> GraphormerBatch."""
    graphs = []
    for rels, target in zip(track_relations, target_names):
        sg = star_expand(rels, target)
        if sg is not None:
            graphs.append(preprocess_graph(sg))
    return collate_track(graphs, max_graphs=max_graphs)
