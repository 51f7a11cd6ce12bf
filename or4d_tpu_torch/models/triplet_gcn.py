"""Triplet GCN — message passing over (subject, edge, object) triplets (port
of ``or4d_tpu/models/triplet_gcn.py``).

Reference ``network_TripletGCN.py``: message (x_i, e, x_j) -> nn1 -> split
(dx_i | e' | dx_j); the node message dx_i + dx_j is summed at the TARGET
node of each edge; nn2 updates the nodes, e' replaces the edge features;
ReLU between layers. All BN uses masked batch statistics
(track_running_stats=False), pooled over every valid edge/node of the batch.

The JAX package runs the per-scene scatter under vmap; here it is a batched
product with the one-hot of the targets, whose summation order is fixed
(``index_add_`` on the card adds in the order its atomics land, so two runs
of the same forward differed by ~1e-6). The triplets' node features are
taken the same way, as products with the one-hots of the sources and the
targets (exact: one 1.0 a row), so their backward sums each node's
cotangents in one order too (a gather's backward adds them with atomics,
and two runs of one train step differed in the gradients' last bits).
"""

from __future__ import annotations

import torch
from torch import nn

from or4d_tpu_torch.models.layers import MLP


class TripletGCNLayer(nn.Module):
    def __init__(self, dim_node: int, dim_edge: int, dim_hidden: int, device=None, generator=None):
        super().__init__()
        self.dim_node, self.dim_edge, self.dim_hidden = dim_node, dim_edge, dim_hidden
        self.nn1 = MLP(2 * dim_node + dim_edge, (dim_hidden, 2 * dim_hidden + dim_edge), on_last=True,
                       device=device, generator=generator)
        self.nn2 = MLP(dim_hidden, (dim_hidden, dim_node), device=device, generator=generator)

    def forward(self, x, edge_feature, edge_index, obj_mask, edge_mask):
        """x (S, O, Dn); edge_feature (S, E, De); edge_index (S, E, 2) of
        (source, target) slots; masks (S, O), (S, E)."""
        S, O, _ = x.shape
        E = edge_index.shape[1]
        src, dst = edge_index[..., 0].long(), edge_index[..., 1].long()
        to_dst = nn.functional.one_hot(dst, O).to(x.dtype)  # (S, E, O)
        x_j = torch.bmm(nn.functional.one_hot(src, O).to(x.dtype), x)  # sources
        x_i = torch.bmm(to_dst, x)  # targets
        triplet = torch.cat([x_i, edge_feature.to(x_i.dtype), x_j], dim=-1)
        h = self.nn1(triplet, edge_mask)
        H, De = self.dim_hidden, self.dim_edge
        dx_i, new_e, dx_j = h[..., :H], h[..., H : H + De], h[..., H + De :]
        msg = (dx_i + dx_j) * edge_mask[..., None].to(h.dtype)
        # each node's messages summed as the product with the (S, O, E)
        # one-hot of the targets: one summation order on every run and
        # device (index_add_ on the card sums in the order its atomics land)
        agg = torch.bmm(to_dst.transpose(1, 2).to(msg.dtype), msg)
        new_x = self.nn2(agg, obj_mask)
        return new_x, new_e


class TripletGCN(nn.Module):
    """Stack of TripletGCN layers (reference TripletGCNModel :61-80)."""

    def __init__(self, num_layers: int = 2, dim_node: int = 256, dim_edge: int = 256, dim_hidden: int = 512,
                 device=None, generator=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TripletGCNLayer(dim_node, dim_edge, dim_hidden, device, generator))

    def forward(self, x, edge_feature, edge_index, obj_mask, edge_mask):
        for i in range(self.num_layers):
            x, edge_feature = getattr(self, f"layer_{i}")(x, edge_feature, edge_index, obj_mask, edge_mask)
            if i < self.num_layers - 1:
                x = torch.relu(x)
                edge_feature = torch.relu(edge_feature)
        return x, edge_feature
