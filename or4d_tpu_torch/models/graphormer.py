"""Graphormer: a transformer over scene-graph tracks for clinical role
prediction (port of ``or4d_tpu/models/graphormer.py``).

Reference: `role_prediction/graphormer/model.py` (role_prediction branch):
  * node ids embed into a (30, H) table, edge types (5, heads), spatial
    positions (64, heads), in/out degrees (64, H); as in the JAX package
    (flax ``nn.Embed``) row 0 is a learned row like the others, no padding
    index;
  * the graph-structural attention bias: spatial-position bias, multi-hop
    edge encoding (per-distance head-mixing products, :159-177) and the
    virtual-token distance, added to every layer's attention logits;
  * a batch is one TRACK of graphs (collator.py:94-148); padded graphs and
    nodes are masked through the collator's bias (``NEG_INF``);
  * pre-LN encoder layers (hidden 80, FFN 80, 8 heads, 12 layers);
    LayerNorm epsilon 1e-6 (flax's), exact (erf) GELU;
  * role readout: mean over TARGET-node embeddings across the whole track
    -> 5-way linear (:211-219).

Attention is two ``torch.einsum`` products, an explicit softmax and
dropout, as the flax module computes it. Linear weights start N(0,
0.02/sqrt(n_layers)) with zero biases, embeddings and the three raw
parameters N(0, 0.02), drawn from a CPU generator seeded with ``seed``.
Dropout (input,
attention probabilities, after attention, after the FFN) draws its masks
from the ``generator`` passed to :meth:`Graphormer.forward`, on that
generator's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as F

NEG_INF = -1e9  # stands in for the collator's float('-inf') without NaN risk

ROLE_NAMES = ["Patient", "head_surgeon", "assistant_surgeon", "circulating_nurse", "anaesthetist"]

LN_EPS = 1e-6  # flax LayerNorm


@dataclasses.dataclass
class GraphormerBatch:
    """One padded track (leading dim G = graphs in the track).

      x            (G, N)         node ids, 0 = padding
      attn_bias    (G, N+1, N+1)  0 or NEG_INF (spatial_pos_max + padding)
      spatial_pos  (G, N, N)      shortest-path buckets, 0 = padding
      in_degree    (G, N)         0 = padding
      out_degree   (G, N)
      edge_input   (G, N, N, D)   multi-hop edge type ids, 0 = padding
      is_target    (G, N)         0 pad / 1 non-target / 2 TARGET node
    """

    x: torch.Tensor
    attn_bias: torch.Tensor
    spatial_pos: torch.Tensor
    in_degree: torch.Tensor
    out_degree: torch.Tensor
    edge_input: torch.Tensor
    is_target: torch.Tensor

    def to(self, device) -> "GraphormerBatch":
        return GraphormerBatch(**{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)})


def dropout(x: torch.Tensor, rate: float, train: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout whose keep-mask is drawn from ``generator`` on its
    own device (the default generator of x's device without one)."""
    if not train or rate == 0.0:
        return x
    dev = generator.device if generator is not None else x.device
    keep = torch.rand(x.shape, generator=generator, device=dev) >= rate
    return torch.where(keep.to(x.device), x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class _Init:
    """The reference initialisation, drawn in order from one CPU generator."""

    def __init__(self, generator: torch.Generator, n_layers: int, device):
        self.g, self.std, self.device = generator, 0.02 / math.sqrt(n_layers), device

    def normal(self, shape, std) -> nn.Parameter:
        return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=self.g).to(self.device))

    def linear(self, n_in: int, n_out: int) -> nn.Linear:
        lin = nn.Linear(n_in, n_out, device="meta")  # no draw from the global generator
        lin.weight = self.normal((n_out, n_in), self.std)
        lin.bias = nn.Parameter(torch.zeros(n_out, device=self.device))
        return lin

    def embedding(self, n: int, d: int) -> nn.Embedding:
        emb = nn.Embedding(n, d, device="meta")
        emb.weight = self.normal((n, d), 0.02)
        return emb


class MultiHeadAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, rate: float, init: _Init):
        super().__init__()
        self.heads, self.d, self.rate = heads, hidden // heads, rate
        self.q = init.linear(hidden, heads * self.d)
        self.k = init.linear(hidden, heads * self.d)
        self.v = init.linear(hidden, heads * self.d)
        self.out = init.linear(heads * self.d, hidden)

    def forward(self, x, attn_bias, train: bool, generator=None):
        G, T, _ = x.shape
        q = self.q(x).reshape(G, T, self.heads, self.d)
        k = self.k(x).reshape(G, T, self.heads, self.d)
        v = self.v(x).reshape(G, T, self.heads, self.d)
        logits = torch.einsum("gthd,gshd->ghts", q, k) * (self.d ** -0.5) + attn_bias
        probs = dropout(torch.softmax(logits, dim=-1), self.rate, train, generator)
        out = torch.einsum("ghts,gshd->gthd", probs, v).reshape(G, T, self.heads * self.d)
        return self.out(out)


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, ffn: int, heads: int, rate: float, attn_rate: float, init: _Init):
        super().__init__()
        self.rate = rate
        self.attn_norm = nn.LayerNorm(hidden, eps=LN_EPS, device=init.device)
        self.attn = MultiHeadAttention(hidden, heads, attn_rate, init)
        self.ffn_norm = nn.LayerNorm(hidden, eps=LN_EPS, device=init.device)
        self.ffn1 = init.linear(hidden, ffn)
        self.ffn2 = init.linear(ffn, hidden)

    def forward(self, x, attn_bias, train: bool, generator=None):
        y = self.attn(self.attn_norm(x), attn_bias, train, generator)
        x = x + dropout(y, self.rate, train, generator)
        y = self.ffn2(F.gelu(self.ffn1(self.ffn_norm(x))))
        return x + dropout(y, self.rate, train, generator)


class Graphormer(nn.Module):
    """``forward(batch, train, perturb=None, generator=None)`` -> (num_classes,)
    logits of the track. ``perturb`` (G, N, hidden) is FLAG's adversarial
    perturbation of the node embeddings."""

    def __init__(self, num_classes: int = 5, n_layers: int = 12, hidden: int = 80, ffn: int = 80, heads: int = 8,
                 dropout: float = 0.1, attn_dropout: float = 0.1, input_dropout: float = 0.1,
                 multi_hop_max_dist: int = 5, num_node_types: int = 30, num_edge_types: int = 5,
                 num_spatial: int = 64, num_degree: int = 64, device=None, seed: int = 0):
        super().__init__()
        self.hidden, self.heads, self.n_layers = hidden, heads, n_layers
        self.input_dropout, self.multi_hop_max_dist = input_dropout, multi_hop_max_dist
        init = _Init(torch.Generator().manual_seed(seed), n_layers, device)
        self.atom_encoder = init.embedding(num_node_types, hidden)
        self.edge_encoder = init.embedding(num_edge_types, heads)
        self.spatial_pos_encoder = init.embedding(num_spatial, heads)
        self.in_degree_encoder = init.embedding(num_degree, hidden)
        self.out_degree_encoder = init.embedding(num_degree, hidden)
        self.edge_dis_encoder = init.normal((40 * heads * heads, 1), 0.02)
        self.graph_token = init.normal((1, hidden), 0.02)
        self.graph_token_virtual_distance = init.normal((1, heads), 0.02)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(hidden, ffn, heads, dropout, attn_dropout, init))
        self.final_ln = nn.LayerNorm(hidden, eps=LN_EPS, device=device)
        self.downstream_out_proj = init.linear(hidden, num_classes)

    def attention_bias(self, batch: GraphormerBatch) -> torch.Tensor:
        """(G, heads, N+1, N+1): the collator's mask, the spatial and
        virtual-token terms and the multi-hop edge encoding, then the mask
        added once more (the reference's "reset" add)."""
        G, N = batch.x.shape
        H = self.heads
        mask = batch.attn_bias[:, None, :, :]
        bias = mask.repeat(1, H, 1, 1)
        bias[:, :, 1:, 1:] += self.spatial_pos_encoder(batch.spatial_pos).permute(0, 3, 1, 2)
        t = self.graph_token_virtual_distance.reshape(1, H, 1)
        bias[:, :, 1:, 0] += t
        bias[:, :, 0, :] += t  # the whole row, column 0 included

        # multi-hop edge encoding (model.py:159-177)
        sp = batch.spatial_pos
        sp = torch.where(sp == 0, torch.ones_like(sp), sp)
        sp = torch.where(sp > 1, sp - 1, sp)
        sp = torch.clamp(sp, 0, self.multi_hop_max_dist)
        D = min(batch.edge_input.shape[3], self.multi_hop_max_dist)
        ei = self.edge_encoder(batch.edge_input[..., :D])  # (G, N, N, D, H)
        flat = ei.permute(3, 0, 1, 2, 4).reshape(D, -1, H)
        mix = self.edge_dis_encoder.reshape(-1, H, H)[:D]
        ei = torch.bmm(flat, mix).reshape(D, G, N, N, H).sum(0) / sp[..., None].float()
        bias[:, :, 1:, 1:] += ei.permute(0, 3, 1, 2)
        return bias + mask

    def forward(self, batch: GraphormerBatch, train: bool = False, perturb: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        G, N = batch.x.shape
        bias = self.attention_bias(batch)
        node = self.atom_encoder(batch.x)
        if perturb is not None:
            node = node + perturb
        node = node + self.in_degree_encoder(batch.in_degree) + self.out_degree_encoder(batch.out_degree)
        h = torch.cat([self.graph_token[None].expand(G, 1, self.hidden), node], dim=1)
        h = dropout(h, self.input_dropout, train, generator)
        for i in range(self.n_layers):
            h = getattr(self, f"layer_{i}")(h, bias, train, generator)
        h = self.final_ln(h)

        # role readout: masked mean over TARGET nodes across the track; the
        # graph-token column counts as a non-target (value 1)
        target = torch.cat([torch.ones_like(batch.is_target[:, :1]), batch.is_target], dim=1)
        tmask = (target == 2).float()[..., None]
        pooled = (h * tmask).sum((0, 1)) / torch.clamp(tmask.sum(), min=1.0)
        return self.downstream_out_proj(pooled)
