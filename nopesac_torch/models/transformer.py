"""Transformer blocks: the DETR encoder/decoder and the LoFTR-style GNN
(counterpart of the JAX package's `models/transformer.py`), batch-first
[B, L, C], with the reference checkpoint's names (packed `in_proj_weight`,
`self_attn`/`multihead_attn`, `linear1/2`, `norm1/2/3`; GNN `q_proj`,
`k_proj`, `v_proj`, `merge`, `mlp.0`, `mlp.2`, `norm1/2`).

Dropout sits where the JAX package puts it (attention weights, both
residual branches, the FFN's hidden layer) and draws its masks from the
`gen` a training forward passes down; with `gen=None` it is the identity.
LayerNorm eps is 1e-6 (the Flax default).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import FLAX_NORM_EPS, dropout


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed q/k/v in_proj),
    batch-first, logits = (q k^T) / sqrt(d_head) as the JAX package computes
    them."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.nhead = nhead
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, gen=None):
        b, lq, c = q.shape
        dh = c // self.nhead
        wq, wk, wv = self.in_proj_weight.chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.chunk(3, dim=0)
        qh = F.linear(q, wq, bq).reshape(b, lq, self.nhead, dh).transpose(1, 2)
        kh = F.linear(k, wk, bk).reshape(b, -1, self.nhead, dh).transpose(1, 2)
        vh = F.linear(v, wv, bv).reshape(b, -1, self.nhead, dh).transpose(1, 2)
        logits = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(dh)  # [B, H, Lq, Lk]
        attn = dropout(torch.softmax(logits, dim=-1), self.dropout, gen)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(b, lq, c)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm DETR encoder layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)

    def forward(self, src, pos, gen=None):
        p = self.dropout
        qk = src + pos
        src = self.norm1(src + dropout(self.self_attn(qk, qk, src, gen), p, gen))
        ff = self.linear2(dropout(F.relu(self.linear1(src)), p, gen))
        return self.norm2(src + dropout(ff, p, gen))


class Encoder(nn.Module):
    """Stack of post-norm encoder layers + a final LayerNorm."""

    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout) for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)

    def forward(self, src, pos, gen=None):
        for layer in self.layers:
            src = layer(src, pos, gen)
        return self.norm(src)


class DecoderLayer(nn.Module):
    """Pre-norm DETR decoder layer."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)

    def forward(self, tgt, memory, pos, query_pos, gen=None):
        p = self.dropout
        t2 = self.norm1(tgt)
        qk = t2 + query_pos
        tgt = tgt + dropout(self.self_attn(qk, qk, t2, gen), p, gen)
        t2 = self.norm2(tgt)
        tgt = tgt + dropout(self.multihead_attn(t2 + query_pos, memory + pos, memory, gen), p, gen)
        t2 = self.norm3(tgt)
        ff = self.linear2(dropout(F.relu(self.linear1(t2)), p, gen))
        return tgt + dropout(ff, p, gen)


class Decoder(nn.Module):
    """Pre-norm decoder returning every layer's output through the shared
    final LayerNorm, [L, B, Q, C] (the heads read the last one at inference
    and the last three in training)."""

    def __init__(self, d_model: int, nhead: int, num_layers: int, dim_feedforward: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, dropout) for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)

    def forward(self, tgt, memory, pos, query_pos, gen=None):
        inters = []
        for layer in self.layers:
            tgt = layer(tgt, memory, pos, query_pos, gen)
            inters.append(tgt)
        return self.norm(torch.stack(inters))


class GNNLayer(nn.Module):
    """LoFTR encoder layer: masked full attention + FFN on [x, message];
    all projections bias-free."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(2 * d_model, 2 * d_model, bias=False),
            nn.ReLU(),
            nn.Linear(2 * d_model, d_model, bias=False),
        )
        self.norm1 = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)

    def forward(self, x, source, x_mask, source_mask):
        b, l, c = x.shape
        dh = c // self.nhead
        q = self.q_proj(x).reshape(b, l, self.nhead, dh).transpose(1, 2)
        k = self.k_proj(source).reshape(b, -1, self.nhead, dh).transpose(1, 2)
        v = self.v_proj(source).reshape(b, -1, self.nhead, dh).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)  # [B, H, L, S]
        keep = (x_mask[:, :, None] & source_mask[:, None, :])[:, None]  # [B, 1, L, S]
        logits = torch.where(keep, logits, logits.new_tensor(-1e9))
        attn = torch.softmax(logits, dim=-1)
        # masked weights are set back to exactly zero after the softmax
        attn = torch.where(keep, attn, attn.new_tensor(0.0))
        msg = torch.matmul(attn, v).transpose(1, 2).reshape(b, l, c)
        msg = self.norm1(self.merge(msg))
        msg = self.norm2(self.mlp(torch.cat([x, msg], dim=-1)))
        return x + msg


class LocalFeatureGNN(nn.Module):
    """Alternating self/cross attention over two plane sets; layer 2i is the
    self layer and 2i+1 the cross layer of pair i. Within a pair the cross
    layer for feat1 sees the already-updated feat0."""

    def __init__(self, d_model: int = 256, nhead: int = 8, num_pairs: int = 9):
        super().__init__()
        self.layers = nn.ModuleList(GNNLayer(d_model, nhead) for _ in range(2 * num_pairs))

    def forward(self, feat0, feat1, mask0: Optional[torch.Tensor] = None,
                mask1: Optional[torch.Tensor] = None):
        b, l0, _ = feat0.shape
        if mask0 is None:
            mask0 = torch.ones((b, l0), dtype=torch.bool, device=feat0.device)
        if mask1 is None:
            mask1 = torch.ones((b, feat1.shape[1]), dtype=torch.bool, device=feat1.device)
        for i in range(0, len(self.layers), 2):
            self_layer, cross_layer = self.layers[i], self.layers[i + 1]
            feat0 = self_layer(feat0, feat0, mask0, mask0)
            feat1 = self_layer(feat1, feat1, mask1, mask1)
            feat0 = cross_layer(feat0, feat1, mask0, mask1)
            feat1 = cross_layer(feat1, feat0, mask1, mask0)
        return feat0, feat1
