"""Graph-transformer core: joint encoder, proposal generator and the
GCN-FFN decoder with the Markov attention bias; counterpart of
edgecape_tpu/models/transformer.py. Batch-first [B, N, C]; K is padded
to max_kpt with invalid keypoints carried as masks.

Train / eval is `module.training`. Dropout sits where the JAX modules
have it and draws from an explicit `torch.Generator` handed down through
the `generator` arguments (never the global state); the hand-written
fused ops are eval-only, and training self-attention goes through
`flash_mha_train`. `return_attn` (the debug forward) asks the decoder for
its kp->image cross-attention maps and keeps it on the plain modules."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import pos_enc, softargmax
from ..ops.fused_decoder import fused_decoder_layer, fused_decoder_stack
from ..ops.flash_attention import flash_mha, flash_mha_train
from ..ops.pos_enc import inverse_sigmoid


def ln(c: int) -> nn.LayerNorm:
    """LayerNorm with torch's eps, like the reference checkpoints."""
    return nn.LayerNorm(c, eps=1e-5)


def ensure_some_valid(valid: torch.Tensor) -> torch.Tensor:
    """A row with no valid keypoint gets index 0 marked valid (keeps the
    softmax finite)."""
    none_valid = ~valid.any(dim=-1, keepdim=True)
    first = torch.zeros_like(valid)
    first[..., 0] = True
    return valid | (none_valid & first)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from `generator` (on the
    generator's device); the identity in eval mode or at rate 0."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a generator")
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) >= rate
    return torch.where(keep.to(x.device), x * (1.0 / (1.0 - rate)),
                       torch.zeros_like(x))


class MultiHeadAttention(nn.Module):
    """torch.nn.MultiheadAttention math, batch-first, with distinct q/k/v
    input widths, a key-validity mask, an additive logit bias and dropout
    on the probabilities. With use_flash, self-attention shapes go to the
    hand-written kernels: flash_mha in eval mode (no bias), and
    flash_mha_train (bias, in-kernel dropout, gradients) in training
    mode up to 512 tokens, as the JAX module: longer training rows take
    the fp32 plain path below (the JAX module's bound, which its TPU
    kernel's VMEM set)."""

    def __init__(self, embed_dim: int, num_heads: int, q_dim: int = None,
                 k_dim: int = None, v_dim: int = None,
                 use_flash: bool = False, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dropout = dropout
        self.q_proj = nn.Linear(q_dim or embed_dim, embed_dim)
        self.k_proj = nn.Linear(k_dim or embed_dim, embed_dim)
        self.v_proj = nn.Linear(v_dim or embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q_in, k_in, v_in, *, key_valid=None, bias=None,
                generator=None, return_probs: bool = False):
        """return_probs: also return the probabilities averaged over the
        heads [B, Nq, Nk] (torch's need_weights), on the plain path."""
        b, nq, _ = q_in.shape
        nk = k_in.shape[1]
        h = self.num_heads
        hd = self.embed_dim // h
        q = self.q_proj(q_in).reshape(b, nq, h, hd)
        k = self.k_proj(k_in).reshape(b, nk, h, hd)
        v = self.v_proj(v_in).reshape(b, nk, h, hd)
        if (self.use_flash and nq == nk and bias is None
                and not self.training and not return_probs):
            out = flash_mha(q, k, v, key_valid).reshape(b, nq,
                                                         self.embed_dim)
            return self.out_proj(out)
        if (self.use_flash and nq == nk and nq <= 512 and self.training
                and not return_probs):
            out = flash_mha_train(
                q, k, v, key_valid, bias, dropout_rate=self.dropout,
                generator=generator).reshape(b, nq, self.embed_dim)
            return self.out_proj(out)
        logits = torch.einsum("bqhd,bkhd->bhqk", (q * (hd ** -0.5)).float(),
                              k.float())
        if bias is not None:
            logits = logits + bias.float()
        if key_valid is not None:
            logits = logits.masked_fill(~key_valid[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(q_in.dtype)
        probs = dropout(probs, self.dropout, self.training, generator)
        out = self.out_proj(torch.einsum(
            "bhqk,bkhd->bqhd", probs, v).reshape(b, nq, self.embed_dim))
        if return_probs:
            return out, probs.mean(dim=1)
        return out


class MarkovBiasMLP(nn.Module):
    """Hop stack [B, K, K, max_hops+1] -> logit bias [B, H, K, K]."""

    def __init__(self, num_heads: int, max_hops: int):
        super().__init__()
        self.fc1 = nn.Linear(max_hops + 1, max_hops + num_heads)
        self.fc2 = nn.Linear(max_hops + num_heads, num_heads)

    def forward(self, hops):
        return self.fc2(F.relu(self.fc1(hops))).permute(0, 3, 1, 2)


def markov_bias_fn(mlp: MarkovBiasMLP, hops: torch.Tensor) -> torch.Tensor:
    """The fused decoder path's bias: the MLP, returned fp32."""
    return mlp(hops).float()


class EncoderLayer(nn.Module):
    """Post-norm self-attention + ReLU FFN; position added to q, k and v."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 use_flash: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            use_flash=use_flash,
                                            dropout=dropout)
        self.norm1 = ln(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = ln(d_model)

    def forward(self, tokens, pos, key_valid, generator=None):
        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        src = tokens + pos
        att = self.self_attn(src, src, src, key_valid=key_valid,
                             generator=generator)
        x = self.norm1(src + drop(att))
        f = self.linear2(drop(F.relu(self.linear1(x))))
        return self.norm2(x + drop(f))


class ProposalGenerator(nn.Module):
    """tanh-modulated support projection; global soft-argmax (loss
    proposal) and local 3x3 soft-argmax (working proposal)."""

    def __init__(self, d_model: int, proj_dim: int, dynamic_proj_dim: int):
        super().__init__()
        self.support_proj = nn.Linear(d_model, proj_dim)
        self.query_proj = nn.Linear(d_model, proj_dim)
        self.dynamic_fc1 = nn.Linear(proj_dim, dynamic_proj_dim)
        self.dynamic_fc2 = nn.Linear(dynamic_proj_dim, d_model)

    def forward(self, query_tokens, support_tokens, spatial_hw):
        h, w = spatial_hw
        fs = self.support_proj(support_tokens)
        fq = self.query_proj(query_tokens)
        dyn = self.dynamic_fc2(F.relu(self.dynamic_fc1(fs)))
        fs = (torch.tanh(dyn) + 1.0) * fs
        sim = torch.matmul(fs.float(), fq.float().transpose(1, 2))
        return (softargmax.global_soft_argmax(sim, h, w), sim,
                softargmax.local_soft_argmax(sim, h, w))


class GCNLayer(nn.Module):
    """Pointwise expansion to kernel_size slices contracted with the
    2-slice adjacency [diag(valid); edge weights]."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int = 2):
        super().__init__()
        self.out_features = out_features
        self.kernel_size = kernel_size
        self.conv = nn.Linear(in_features, out_features * kernel_size)

    def forward(self, x, adj):
        b, k, _ = x.shape
        y = self.conv(x).reshape(b, k, self.kernel_size, self.out_features)
        out = torch.einsum("bvsc,bswv->bwc", y.float(), adj.float())
        return F.relu(out).to(x.dtype)


class DecoderLayer(nn.Module):
    """Keypoint-token refinement: (1) self-attention (optionally Markov
    biased), (2) concat-position cross-attention at 2*d_model squeezed by
    the choker, (3) GCN feed-forward, (4) optional two-way image<-keypoint
    attention (skeleton refiner)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, *,
                 attn_bias: bool = False, max_hops: int = 4,
                 two_way_attn: bool = False, use_flash: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.attn_bias = attn_bias
        self.two_way = two_way_attn
        self.dropout = dropout
        if attn_bias:
            self.bias_mlp = MarkovBiasMLP(nhead, max_hops)
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            use_flash=use_flash,
                                            dropout=dropout)
        self.norm1 = ln(d_model)
        self.cross_attn = MultiHeadAttention(2 * d_model, nhead,
                                             v_dim=d_model,
                                             use_flash=use_flash,
                                             dropout=dropout)
        self.choker = nn.Linear(2 * d_model, d_model)
        self.norm2 = ln(d_model)
        self.gcn = GCNLayer(d_model, dim_feedforward)
        self.ffn2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = ln(d_model)
        if two_way_attn:
            self.two_way_attn = MultiHeadAttention(2 * d_model, nhead,
                                                   v_dim=d_model,
                                                   use_flash=use_flash,
                                                   dropout=dropout)
            self.two_way_choker = nn.Linear(2 * d_model, d_model)
            self.norm4 = ln(d_model)

    def forward(self, kp_tokens, img_tokens, *, kp_valid, kp_query_pos,
                img_pos, hop_stack=None, adj=None, generator=None,
                return_attn: bool = False):
        """Returns (kp tokens, img tokens[, the cross-attention
        probabilities averaged over heads [B, K, HW] with return_attn])."""
        def drop(t):
            return dropout(t, self.dropout, self.training, generator)

        bias = None
        if self.attn_bias and hop_stack is not None:
            bias = self.bias_mlp(hop_stack)
        att = self.self_attn(kp_tokens, kp_tokens, kp_tokens,
                             key_valid=kp_valid, bias=bias,
                             generator=generator)
        x = self.norm1(kp_tokens + drop(att))
        q = torch.cat([x, kp_query_pos], dim=-1)
        k = torch.cat([img_tokens, img_pos], dim=-1)
        attn_map = None
        if return_attn:
            att, attn_map = self.cross_attn(q, k, img_tokens,
                                            generator=generator,
                                            return_probs=True)
        else:
            att = self.cross_attn(q, k, img_tokens, generator=generator)
        att = self.choker(att)
        x = self.norm2(x + drop(att))
        f = self.ffn2(drop(self.gcn(x, adj)))
        x = self.norm3(x + drop(f))
        if self.two_way:
            q2 = torch.cat([img_tokens, img_pos], dim=-1)
            k2 = torch.cat([x, kp_query_pos], dim=-1)
            att2 = self.two_way_choker(self.two_way_attn(
                q2, k2, x, generator=generator))
            img_tokens = self.norm4(img_tokens + drop(att2))
        if return_attn:
            return x, img_tokens, attn_map
        return x, img_tokens


class RefPointHead(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_model)
        self.fc2 = nn.Linear(d_model, d_model)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class KptBranch(nn.Module):
    """3 x (Linear + GELU) then a final Linear to a coordinate delta."""

    def __init__(self, d_model: int):
        super().__init__()
        self.fc0 = nn.Linear(d_model, d_model)
        self.fc1 = nn.Linear(d_model, d_model)
        self.fc2 = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, 2)

    def forward(self, x):
        for fc in (self.fc0, self.fc1, self.fc2):
            x = F.gelu(fc(x), approximate="none")
        return self.out(x)


class Decoder(nn.Module):
    """Iterative refinement: per layer, sine-embed the current coords ->
    ref_point_head -> decoder layer -> kpt_branch delta ->
    sigmoid(inverse_sigmoid(prev) + delta), with the gradient stopped at
    the initial proposals and between layers. The coordinate trajectory
    stays fp32. With use_flash, in eval mode and without return_attn,
    every layer goes through the hand-written fused_decoder_layer op (which
    takes no gradient); `decode_stacked` is the whole decoder as one op."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 num_layers: int, *, attn_bias: bool = False,
                 max_hops: int = 4, num_feats: int = 128,
                 use_flash: bool = False, dropout: float = 0.0):
        super().__init__()
        self.nhead = nhead
        self.attn_bias = attn_bias
        self.num_feats = num_feats
        self.use_flash = use_flash
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward,
                         attn_bias=attn_bias, max_hops=max_hops,
                         use_flash=use_flash, dropout=dropout)
            for _ in range(num_layers))
        self.norm = ln(d_model)
        self.ref_point_head = RefPointHead(d_model)
        self.kpt_branches = nn.ModuleList(KptBranch(d_model)
                                          for _ in range(num_layers))

    def forward(self, kp_tokens, img_tokens, *, kp_valid, img_pos,
                initial_proposals, adj, hop_stack=None, generator=None,
                return_attn: bool = False):
        """Returns (normed tokens per layer [L, B, K, C], the point
        trajectory [initial, after layer 0, ...][, attention maps
        [L, B, K, HW] with return_attn])."""
        kp_valid = ensure_some_valid(kp_valid)
        bi = initial_proposals.float().detach()
        points = [bi]
        intermediate = []
        attn_maps = []
        x = kp_tokens
        b, k = x.shape[:2]
        use_fused = self.use_flash and not self.training and not return_attn
        for layer, branch in zip(self.layers, self.kpt_branches):
            query_pos = self.ref_point_head(
                pos_enc.sine_coords(bi, self.num_feats).to(x.dtype))
            if use_fused:
                if self.attn_bias and hop_stack is not None:
                    bias = markov_bias_fn(layer.bias_mlp, hop_stack)
                else:
                    bias = torch.zeros((b, self.nhead, k, k),
                                       dtype=torch.float32, device=x.device)
                x = fused_decoder_layer(
                    x, query_pos, img_tokens, img_pos[0], kp_valid, bias,
                    adj, layer, num_heads=self.nhead, eps=1e-5)
            else:
                out = layer(
                    x, img_tokens, kp_valid=kp_valid, kp_query_pos=query_pos,
                    img_pos=img_pos, hop_stack=hop_stack, adj=adj,
                    generator=generator, return_attn=return_attn)
                x, img_tokens = out[:2]
                if return_attn:
                    attn_maps.append(out[2])
            intermediate.append(self.norm(x))
            bi_pred = torch.sigmoid(inverse_sigmoid(bi) + branch(x))
            bi = bi_pred.detach()
            points.append(bi_pred)
        if return_attn:
            return (torch.stack(intermediate, dim=0), points,
                    torch.stack(attn_maps, dim=0))
        return torch.stack(intermediate, dim=0), points

    def decode_stacked(self, kp_tokens, img_tokens, *, kp_valid, img_pos,
                       initial_proposals, adj, hop_stack=None):
        """Eval fast path: the whole decoder, layers and the glue between
        them (bias MLP, sine embedding + ref_point_head, kpt_branch,
        trajectory update, the head recompute from the final-normed
        tokens), through the hand-written fused_decoder_stack op. Returns
        the head-recompute predictions [L, B, K, 2] and the point
        trajectory list: what EdgeCape.decode returns."""
        kp_valid = ensure_some_valid(kp_valid)
        bi = initial_proposals.float().detach()
        outputs, points_arr = fused_decoder_stack(
            kp_tokens, bi, img_tokens, img_pos[0], kp_valid,
            hop_stack if self.attn_bias else None, adj, self,
            num_heads=self.nhead, num_feats=self.num_feats, eps=1e-5)
        return outputs, [bi] + list(points_arr.unbind(0))
