"""EdgeCape keypoint head over frozen backbone features; counterpart of
edgecape_tpu/models/edgecape.py with its encode_support / encode_query /
decode split (the support context is computed once per episode group
and shared by its queries).

Train / eval is `module.training`; in training mode the dropout layers
draw from the `generator` argument, the encoder and decoder run as
plain modules (the fused encoder / decoder ops are eval-only and take no
gradient) and, with use_flash, self-attention goes through
flash_mha_train. The masked-keypoint reconstruction branch of the
curriculum is composed by the training step (train/loop.py) from
`encode`, `mask_tokens` and two calls of `decode`."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..ops import pos_enc
from ..ops.fused_encoder import fused_encoder_stack
from ..ops.kernel_config import decoder_stack_default, require_widths
from ..ops.kernels import width_misfits
from .head import pool_support_keypoints
from .skeleton import SkeletonPredictor
from .transformer import (Decoder, EncoderLayer, ProposalGenerator,
                          inverse_sigmoid)


class SupportContext(NamedTuple):
    kp_tokens0: torch.Tensor       # [B, K, C]
    kp_valid: torch.Tensor         # [B, K] bool
    mask_s: torch.Tensor           # [B, K]
    adj: torch.Tensor              # [B, 2, K, K]
    hop_stack: Optional[torch.Tensor]
    raw_adj: torch.Tensor          # [B, K, K]


class EncodeOutput(NamedTuple):
    img_tokens: torch.Tensor
    kp_tokens: torch.Tensor
    kp_tokens_pre: torch.Tensor
    img_pos: torch.Tensor
    kp_valid: torch.Tensor
    adj: torch.Tensor
    hop_stack: Optional[torch.Tensor]
    raw_adj: torch.Tensor
    proposals: torch.Tensor
    proposals_for_loss: torch.Tensor
    similarity: torch.Tensor
    spatial_hw: tuple


class ModelOutput(NamedTuple):
    outputs: torch.Tensor          # [L, B, K, 2] per-layer predictions
    points: list                   # trajectory [initial, ...]
    encode: EncodeOutput


# The head's fused ops, whose widths are checked when it is built for the card
HEAD_OPS = ("flash_mha (encoder)", "flash_mha (keypoints)",
            "fused_encoder_stack", "fused_decoder_layer",
            "fused_decoder_stack")


class EdgeCape(nn.Module):
    def __init__(self, cfg, use_flash: bool = False, device=None):
        """cfg: a model configuration with the fields of
        edgecape_tpu.config.ModelConfig (read by attribute). use_flash
        routes eval through the hand-written fused ops and training
        self-attention through flash_mha_train. device: where the model
        will run; on a CUDA device with use_flash, widths the kernels do
        not take raise ValueError here (ops/kernel_config.py
        require_widths)."""
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.use_flash = flash = bool(use_flash)
        if flash:
            require_widths(HEAD_OPS, width_misfits(c), device)
        drop = float(c.dropout)
        self.input_proj = nn.Linear(c.backbone_dim, c.d_model)
        self.query_proj = nn.Linear(c.backbone_dim, c.d_model)
        self.skeleton = SkeletonPredictor(
            d_model=c.d_model, nhead=c.nhead,
            num_layers=c.skeleton_num_layers,
            dim_feedforward=c.dim_feedforward, max_hop=c.max_hops,
            learn_skeleton=c.learn_skeleton,
            adj_normalization=c.adj_normalization,
            use_zero_conv=c.use_zero_conv, use_flash=flash,
            image_feat_dim=c.backbone_dim, dropout=drop)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(c.d_model, c.nhead, c.dim_feedforward,
                         use_flash=flash, dropout=drop)
            for _ in range(c.num_encoder_layers))
        self.proposal_gen = ProposalGenerator(
            c.d_model, c.similarity_proj_dim, c.dynamic_proj_dim)
        self.decoder = Decoder(
            c.d_model, c.nhead, c.dim_feedforward, c.num_decoder_layers,
            attn_bias=c.attn_bias, max_hops=c.max_hops,
            num_feats=c.num_feats, use_flash=flash, dropout=drop)
        self.mask_token = nn.Parameter(torch.zeros(1, c.d_model))

    def _img_pos(self, b, gh, gw, dtype, device):
        c = self.cfg
        grid = pos_enc.sine_grid(gh, gw, c.num_feats, device=device)
        return grid.reshape(gh * gw, c.d_model).expand(
            b, gh * gw, c.d_model).to(dtype)

    def encode_support(self, feat_s, target_s, mask_s, binary_adj,
                       generator=None) -> SupportContext:
        """feat_s [B, S, gh, gw, Cb]; target_s [B, S, K, H, W]; mask_s
        [B, K]; binary_adj [B, K, K]."""
        b, s, gh, gw, _ = feat_s.shape
        img_pos = self._img_pos(b, gh, gw, feat_s.dtype, feat_s.device)
        pooled = pool_support_keypoints(feat_s, target_s) * mask_s[..., None]
        kp_tokens0 = self.query_proj(pooled)
        kp_valid = mask_s > 0
        adj, hop_stack, raw_adj = self.skeleton(
            binary_adj, kp_tokens0, feat_s, kp_valid, img_pos,
            generator=generator)
        return SupportContext(kp_tokens0, kp_valid, mask_s, adj, hop_stack,
                              raw_adj)

    def encode_query(self, feat_q, ctx: SupportContext,
                     generator=None) -> EncodeOutput:
        """Joint encoder over [query image tokens ++ support kp tokens],
        then the proposal generator. With use_flash, in eval mode, the
        encoder runs through the hand-written fused_encoder_stack op."""
        c = self.cfg
        b, gh, gw, _ = feat_q.shape
        hw = gh * gw
        img_tokens = self.input_proj(feat_q.reshape(b, hw, -1))
        img_pos = self._img_pos(b, gh, gw, img_tokens.dtype, feat_q.device)
        kp_tokens0 = ctx.kp_tokens0
        k = kp_tokens0.shape[1]
        tokens = torch.cat([img_tokens, kp_tokens0], dim=1)
        pos = torch.cat([img_pos, img_pos.new_zeros(b, k, c.d_model)], dim=1)
        valid = torch.cat([torch.ones(b, hw, dtype=torch.bool,
                                      device=feat_q.device), ctx.kp_valid],
                          dim=1)
        if self.use_flash and not self.training:
            tokens = fused_encoder_stack(tokens, pos[0], valid,
                                         self.encoder_layers,
                                         num_heads=c.nhead, eps=1e-5)
        else:
            for layer in self.encoder_layers:
                tokens = layer(tokens, pos, valid, generator=generator)
        enc_img, enc_kp = tokens[:, :hw], tokens[:, hw:]
        prop_loss, sim, proposals = self.proposal_gen(enc_img, enc_kp,
                                                      (gh, gw))
        return EncodeOutput(
            img_tokens=enc_img, kp_tokens=enc_kp, kp_tokens_pre=kp_tokens0,
            img_pos=img_pos, kp_valid=ctx.kp_valid, adj=ctx.adj,
            hop_stack=ctx.hop_stack, raw_adj=ctx.raw_adj,
            proposals=proposals, proposals_for_loss=prop_loss,
            similarity=sim.reshape(b, k, gh, gw), spatial_hw=(gh, gw))

    def encode(self, feat_q, feat_s, target_s, mask_s, binary_adj,
               generator=None) -> EncodeOutput:
        """Full encode (support then query phase)."""
        ctx = self.encode_support(feat_s, target_s, mask_s, binary_adj,
                                  generator=generator)
        return self.encode_query(feat_q, ctx, generator=generator)

    def decode(self, kp_tokens, img_tokens, proposals, adj, hop_stack,
               kp_valid, img_pos, generator=None,
               return_attn: bool = False):
        """([L, B, K, 2] per-layer predictions via the head recompute from
        the normed tokens, without the decoder's gradient stop between
        layers; point trajectory[; attention maps [L, B, K, HW] with
        return_attn]). With use_flash, in eval mode, without return_attn
        and with the decoder_stack switch on (ops/kernel_config.py), the
        whole decoder runs as one op, tolerance-equal to the layer
        chain."""
        if (self.use_flash and not self.training and not return_attn
                and decoder_stack_default()):
            return self.decoder.decode_stacked(
                kp_tokens, img_tokens, kp_valid=kp_valid, img_pos=img_pos,
                initial_proposals=proposals, adj=adj, hop_stack=hop_stack)
        dec_out = self.decoder(
            kp_tokens, img_tokens, kp_valid=kp_valid, img_pos=img_pos,
            initial_proposals=proposals, adj=adj, hop_stack=hop_stack,
            generator=generator, return_attn=return_attn)
        inter, points = dec_out[:2]
        outs = [torch.sigmoid(self.decoder.kpt_branches[i](inter[i])
                              + inverse_sigmoid(points[i]))
                for i in range(inter.shape[0])]
        if return_attn:
            return torch.stack(outs, dim=0), points, dec_out[2]
        return torch.stack(outs, dim=0), points

    def mask_tokens(self, kp_tokens, random_mask, kp_valid):
        """Masked valid keypoints take the learnable mask token; the kept
        tokens are detached. random_mask [B, K]: 1 keep, 0 mask."""
        keep = random_mask[..., None].to(kp_tokens.dtype)
        fill = (1.0 - keep) * kp_valid[..., None].to(kp_tokens.dtype) \
            * self.mask_token
        return kp_tokens.detach() * keep + fill

    def forward(self, feat_q, feat_s, target_s, mask_s, binary_adj,
                generator=None) -> ModelOutput:
        enc = self.encode(feat_q, feat_s, target_s, mask_s, binary_adj,
                          generator=generator)
        outputs, points = self.decode(
            enc.kp_tokens, enc.img_tokens, enc.proposals, enc.adj,
            enc.hop_stack, enc.kp_valid, enc.img_pos, generator=generator)
        return ModelOutput(outputs=outputs, points=points, encode=enc)
