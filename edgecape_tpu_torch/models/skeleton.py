"""Skeleton predictor: learned continuous edge weights + Markov hop
stack; counterpart of edgecape_tpu/models/skeleton.py. Shots are folded
into the batch for the two-way refine layers."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import graph
from .transformer import DecoderLayer, ensure_some_valid


class SkeletonPredictor(nn.Module):
    def __init__(self, d_model: int = 256, nhead: int = 8,
                 num_layers: int = 3, dim_feedforward: int = 384,
                 max_hop: int = 4, learn_skeleton: bool = False,
                 adj_normalization: bool = True, use_zero_conv: bool = True,
                 use_flash: bool = False, image_feat_dim: int = 384,
                 dropout: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.max_hop = max_hop
        self.learn_skeleton = learn_skeleton
        self.adj_normalization = adj_normalization
        self.use_zero_conv = use_zero_conv
        if learn_skeleton:
            self.image_project = nn.Linear(image_feat_dim, d_model)
            self.refine = nn.ModuleList(
                DecoderLayer(d_model, nhead, dim_feedforward,
                             two_way_attn=True, use_flash=use_flash,
                             dropout=dropout)
                for _ in range(num_layers))
            if use_zero_conv:
                self.zero_conv_w = nn.Parameter(torch.zeros(1))
                self.zero_conv_b = nn.Parameter(torch.zeros(1))

    def forward(self, binary_adj, kp_tokens, support_feats, kp_valid,
                img_pos, generator=None):
        """binary_adj [B, K, K]; kp_tokens [B, K, C]; support_feats
        [B, S, gh, gw, Cb]; kp_valid [B, K] bool; img_pos [B, gh*gw, C].
        Returns adj [B, 2, K, K], hop_stack [B, K, K, max_hop+1] or None,
        raw_adj [B, K, K]. `generator` feeds the refine layers' dropout in
        training mode."""
        kp_invalid = ~kp_valid
        gt_norm = graph.normalize_adjacency(binary_adj, kp_invalid)
        if not self.learn_skeleton:
            return gt_norm, None, (binary_adj > 0).float()

        b, s, gh, gw, _ = support_feats.shape
        k = kp_tokens.shape[1]
        c = self.d_model
        refine_adj = graph.soft_normalize_adjacency(
            binary_adj.to(kp_tokens.dtype), kp_invalid,
            normalize=self.adj_normalization, stack_diag=True)
        img = self.image_project(support_feats.reshape(b, s, gh * gw, -1))

        def rep(t):
            return t[:, None].expand(b, s, *t.shape[1:]).reshape(
                b * s, *t.shape[1:])

        x = rep(kp_tokens)
        img = img.reshape(b * s, gh * gw, c)
        adj_rep = rep(refine_adj)
        valid_rep = ensure_some_valid(rep(kp_valid))
        zero_pos = torch.zeros_like(x)
        img_pos_rep = rep(img_pos)
        for layer in self.refine:
            x, img = layer(x, img, kp_valid=valid_rep, kp_query_pos=zero_pos,
                           img_pos=img_pos_rep, adj=adj_rep,
                           generator=generator)
        refined = x.reshape(b, s, k, c).mean(dim=1)

        unit = refined / (torch.linalg.norm(refined, dim=-1, keepdim=True)
                          + 1e-8)
        gram = torch.matmul(unit.float(), unit.float().transpose(1, 2))
        gram = 0.5 * (gram + gram.transpose(1, 2))
        if self.use_zero_conv:
            gram = gram * self.zero_conv_w[0] + self.zero_conv_b[0]
        combined = F.relu(binary_adj.to(gram.dtype) + gram)
        adj = graph.soft_normalize_adjacency(
            combined, kp_invalid, normalize=self.adj_normalization,
            stack_diag=True)
        valid_f = kp_valid.to(combined.dtype)
        raw_adj = combined * valid_f[:, :, None] * valid_f[:, None, :]
        hop_stack = graph.markov_hop_stack(adj[:, 1], self.max_hop)
        return adj, hop_stack, raw_adj
