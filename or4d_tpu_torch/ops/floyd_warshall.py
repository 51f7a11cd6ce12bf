"""All-pairs shortest paths and multi-hop edge features for Graphormer
(port of ``or4d_tpu/ops/floyd_warshall.py``), with the reference
Cython module's semantics (`role_prediction/graphormer/algos.pyx:11-89`):

  * MAX_DIST = 12; diagonal 0; missing edges start at 12;
  * ``path`` holds the LAST pivot k that strictly improved a pair (``<``);
  * after the sweep, pairs at distance >= 12 are clamped to 12 in both
    matrices (12 in ``path`` marks "unreachable");
  * path reconstruction treats pivot 0 as "direct edge", so node 0 is never
    reported as an intermediate (a quirk of the reference, kept);
  * ``gen_edge_input`` fills unwritten entries with -1.

Graphs have at most 64 nodes: :func:`floyd_warshall` is a loop over the
pivots of (n, n) int32 min-plus updates on the tensor's own device (the
callers pass CPU tensors: this is data preparation). ``get_all_edges`` and
``gen_edge_input`` are numpy, run once per sample.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_DIST = 12  # reference: algos.pyx:9


def floyd_warshall(adj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shortest path lengths and last-improving-pivot matrix.

    ``adj``: (n, n) bool/int adjacency (nonzero = edge of cost adj[i, j],
    zero = no edge). Returns (M, path), both (n, n) int32 on adj's device.
    """
    n = adj.shape[0]
    adj = adj.to(torch.int32)
    big = torch.tensor(MAX_DIST, dtype=torch.int32, device=adj.device)
    M = torch.where(adj != 0, adj, big)
    M.fill_diagonal_(0)
    path = torch.zeros((n, n), dtype=torch.int32, device=adj.device)
    for k in range(n):
        cand = M[:, k, None] + M[None, k, :]
        better = cand < M
        M = torch.where(better, cand, M)
        path = torch.where(better, torch.tensor(k, dtype=torch.int32, device=adj.device), path)
    unreachable = M >= MAX_DIST
    return torch.where(unreachable, big, M), torch.where(unreachable, big, path)


def get_all_edges(path: np.ndarray, i: int, j: int) -> list[int]:
    """Reference-compatible path reconstruction (algos.pyx:57-62): the
    intermediate pivots on the shortest i->j path; pivot 0 ends the
    recursion."""
    path = np.asarray(path)
    k = int(path[i][j])
    if k == 0:
        return []
    return get_all_edges(path, i, k) + [k] + get_all_edges(path, k, j)


def gen_edge_input(max_dist: int, path: np.ndarray, edge_feat: np.ndarray) -> np.ndarray:
    """Multi-hop edge features along shortest paths (algos.pyx:64-89).

    ``path``: (n, n) pivot matrix from :func:`floyd_warshall`.
    ``edge_feat``: (n, n, F) integer per-edge features.
    Returns (n, n, max_dist, F) int64, -1-filled, where entry [i, j, d] is the
    feature of the d-th edge on the reconstructed i->j path.
    """
    path = np.asarray(path)
    edge_feat = np.asarray(edge_feat, dtype=np.int64)
    n = path.shape[0]
    F = edge_feat.shape[-1]
    out = -np.ones((n, n, int(max_dist), F), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            if i == j or path[i][j] == MAX_DIST:
                continue
            hops = [i] + get_all_edges(path, i, j) + [j]
            for d in range(min(len(hops) - 1, int(max_dist))):
                out[i, j, d] = edge_feat[hops[d], hops[d + 1]]
    return out
