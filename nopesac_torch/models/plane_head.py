"""PlaneTR detection head (counterpart of the JAX package's
`models/plane_head.py`; reference checkpoint names under `sem_seg_head.`).

  * sine pos-emb on res5 tokens, 1x1 input projection 2048 -> 256
  * 6-layer post-norm encoder, learned queries, 6-layer pre-norm decoder
    (the heads read the last layer's normed output at inference and the
    last NUM_AUX layers' in training, for deep supervision)
  * `top_down` FPN pixel decoder (laterals res2..res5 + encoder memory inject)
  * mask logits = einsum(plane_embedding, pixel_embedding)
  * plane/no-plane classifier, plane-param MLP, plane-center MLP + pixel map
  * with `depth_on` (MODEL.DEPTH_ON), a second top-down decoder
    `top_down_depth` and a 1x1 `depth` conv: per-pixel depth at H/4 x W/4

Compute dtypes, as the JAX package's `PlaneTRHead(dtype, fpn_train_dtype)`:
the input projection, the transformer, the query embeddings and every
query-side head run in f32 under every policy (the input projection casts
res5 to f32). The pixel path (the top-down decoder, pixel_embedding,
pixel_plane_center, and the depth branch) runs in `dtype` in eval mode and in `fpn_train_dtype`
in train mode. The mask einsum is f32: pixel_embedding's output is widened
first.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import MLP, Conv2d, Linear, conv_bn, set_compute_dtype, sine_position_embedding, \
    upsample_bilinear
from .transformer import Decoder, Encoder


class TopDown(nn.Module):
    """FPN-ish pixel decoder with encoder-memory injection; every lateral is
    a 1x1 conv + BN + relu, and the 2x upsample is bilinear with
    align_corners=False."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), channel: int = 256,
                 m_dim: int = 256):
        super().__init__()
        c1, c2, c3, c4 = in_channels
        self.c1_conv = conv_bn(c1, channel)
        self.c2_conv = conv_bn(c2, channel)
        self.c3_conv = conv_bn(c3, channel)
        self.c4_conv = conv_bn(c4, channel)
        self.up_conv1 = conv_bn(channel, channel)
        self.up_conv2 = conv_bn(channel, channel)
        self.up_conv3 = conv_bn(channel, channel)
        self.m_conv_dict = nn.ModuleDict({"m4": conv_bn(m_dim, channel)})

    def forward(self, c1, c2, c3, c4, memory):
        def up(x):
            return upsample_bilinear(x, x.shape[2] * 2, x.shape[3] * 2)

        p4 = self.c4_conv(c4) + self.m_conv_dict["m4"](memory)
        p3 = self.up_conv3(up(p4)) + self.c3_conv(c3)
        p2 = self.up_conv2(up(p3)) + self.c2_conv(c2)
        return self.up_conv1(up(p2)) + self.c1_conv(c1)


class PlaneTRHead(nn.Module):
    """Plane detection head producing class/mask/param/center predictions."""

    NUM_AUX = 3  # decoder layers supervised in training (the last three)

    def __init__(self, num_queries: int = 50, hidden_dim: int = 256, nheads: int = 8,
                 enc_layers: int = 6, dec_layers: int = 6, num_classes: int = 1,
                 mask_dim: int = 256, channel: int = 256, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32,
                 fpn_train_dtype: torch.dtype = torch.float32, depth_on: bool = False):
        super().__init__()
        self.depth_on = depth_on
        self.hidden_dim = hidden_dim
        self.input_proj = Conv2d(2048, hidden_dim, 1)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.context_SA = Encoder(hidden_dim, nheads, enc_layers, dropout=dropout)
        self.context2plane_decoder = Decoder(hidden_dim, nheads, dec_layers, dropout=dropout)
        self.top_down = TopDown(channel=channel, m_dim=hidden_dim)
        self.plane_embedding = MLP(hidden_dim, hidden_dim, mask_dim, 3)
        self.plane_prob = Linear(hidden_dim, num_classes + 1)
        self.pixel_embedding = Conv2d(channel, mask_dim, 1)
        self.plane_param = MLP(hidden_dim, hidden_dim, 3, 3)
        self.plane_center = MLP(hidden_dim, hidden_dim, 2, 3)
        self.pixel_plane_center = Conv2d(channel, 2, 1)
        pixel_path = [self.top_down, self.pixel_embedding, self.pixel_plane_center]
        if depth_on:
            self.top_down_depth = TopDown(channel=channel, m_dim=hidden_dim)
            self.depth = Conv2d(channel, 1, 1)
            pixel_path += [self.top_down_depth, self.depth]
        for module in pixel_path:
            set_compute_dtype(module, dtype, fpn_train_dtype)
        self._pos_cache: Dict[tuple, torch.Tensor] = {}

    def _pos(self, hc: int, wc: int, device) -> torch.Tensor:
        key = (hc, wc, str(device))
        if key not in self._pos_cache:
            self._pos_cache[key] = sine_position_embedding(hc, wc, self.hidden_dim // 2).to(device)
        return self._pos_cache[key]

    def forward(self, features: Dict[str, torch.Tensor], gen=None):
        """Returns (outputs, query features [B, Q, C]). outputs: pred_logits
        [B,Q,2], pred_mask_logits [B,Q,H/4,W/4], pred_params [B,Q,3],
        pred_centers [B,Q,2], pixel_centers [B,2,H/4,W/4], with depth_on
        pixel_depth [B,1,H/4,W/4] in the pixel path's dtype; in training also
        aux_outputs, a list of the first three keys' dicts of the earlier
        supervised decoder layers. `gen` drives the transformer's dropout."""
        c1, c2, c3, c4 = (features["res2"], features["res3"], features["res4"],
                          features["res5"])
        b, _, hc, wc = c4.shape
        pos = self._pos(hc, wc, c4.device)[None].expand(b, -1, -1)
        src = self.input_proj(c4).flatten(2).transpose(1, 2)  # [B, hc*wc, C], row-major
        memory = self.context_SA(src, pos, gen)

        query_pos = self.query_embed.weight[None].expand(b, -1, -1)
        hs = self.context2plane_decoder(torch.zeros_like(query_pos), memory, pos, query_pos, gen)
        hs = hs[-self.NUM_AUX:] if self.training else hs[-1:]  # [L, B, Q, C]

        memory_map = memory.transpose(1, 2).reshape(b, self.hidden_dim, hc, wc)
        p_context = self.top_down(c1, c2, c3, c4, memory_map)

        plane_emb = self.plane_embedding(hs)  # [L, B, Q, C]
        pixel_emb = self.pixel_embedding(p_context)  # [B, C, H, W]
        heads = {"pred_logits": self.plane_prob(hs),
                 "pred_mask_logits": torch.einsum("lbqc,bchw->lbqhw", plane_emb,
                                                  pixel_emb.to(torch.float32)),
                 "pred_params": self.plane_param(hs),
                 "pred_centers": torch.sigmoid(self.plane_center(hs))}
        out = {k: v[-1] for k, v in heads.items()}
        out["pixel_centers"] = torch.sigmoid(self.pixel_plane_center(p_context))
        if self.depth_on:
            out["pixel_depth"] = self.depth(self.top_down_depth(c1, c2, c3, c4, memory_map))
        if self.training:
            out["aux_outputs"] = [{k: v[i] for k, v in heads.items()}
                                  for i in range(hs.shape[0] - 1)]
        return out, hs[-1]
