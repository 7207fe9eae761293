"""DINOv2 ViT trunks in PyTorch (ViT-S/14 by default, any DinoV2Config:
ViT-B/14 is 768 channels in 12 heads, depth 12; ViT-L/14 1024 in 16,
depth 24); counterpart of edgecape_tpu/models/dinov2.py.

Channels-last [B, H, W, C] images like the JAX module, the patch embed as
reshape + matmul, the position embedding stored at the target grid,
pre-norm blocks with LayerScale and a fused qkv projection, exact GELU.
`fast_forward` is the bf16 eval path: every block goes through the
hand-written `fused_vit_block` op, or every pair of blocks through
`fused_vit_block2` when the vit_pair_blocks switch is on; 384 channels
in 6 heads run on the resident ViT kernels, every other width the
kernels take (ops/kernels.py width_misfits: 64..1024 channels in steps
of 64, heads of up to 128) on the wide route."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from ..ops.flash_attention import flash_mha
from ..ops.kernel_config import vit_pair_blocks_default


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    layerscale_init: float = 1e-5
    pretrain_grid: int = 37
    ln_eps: float = 1e-6


VIT_S14 = DinoV2Config()


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.use_flash:
            out = flash_mha(q.contiguous(), k.contiguous(), v.contiguous())
        else:
            q = q * (hd ** -0.5)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.proj(out.reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, cfg: DinoV2Config, use_flash: bool = False):
        super().__init__()
        c = cfg.embed_dim
        hidden = int(c * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.attn = Attention(c, cfg.num_heads, use_flash)
        self.ls1 = nn.Parameter(torch.full((c,), cfg.layerscale_init))
        self.norm2 = nn.LayerNorm(c, eps=cfg.ln_eps)
        self.mlp_fc1 = nn.Linear(c, hidden)
        self.mlp_fc2 = nn.Linear(hidden, c)
        self.ls2 = nn.Parameter(torch.full((c,), cfg.layerscale_init))

    def forward(self, x):
        x = x + self.ls1 * self.attn(self.norm1(x))
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.ls2 * self.mlp_fc2(h)


def fused_ops(model_cfg) -> tuple:
    """The trunk's fused ops that a model of this configuration launches,
    whose widths are checked when it is built for the card: the fused
    block (extract_features' bf16 path) at bf16 compute, flash_mha in the
    blocks' attention at fp32."""
    if model_cfg.compute_dtype == "bfloat16":
        return ("fused_vit_block",)
    return ("flash_mha (ViT)",)


def width_misfits(model_cfg, cfg: DinoV2Config = VIT_S14) -> dict:
    """ops/kernels.py width_misfits of a head configuration over this
    trunk (its width, heads, patch and MLP hidden)."""
    return kernels.width_misfits(
        model_cfg, vit_dim=cfg.embed_dim, vit_heads=cfg.num_heads,
        patch=cfg.patch_size, vit_hidden=int(cfg.embed_dim * cfg.mlp_ratio))


def _patches(images: torch.Tensor, p: int):
    """[B, H, W, 3] -> ([B, gh*gw, p*p*3], gh, gw), remainder pixels
    cropped like a stride-p conv; flattening order (ph, pw, 3)."""
    b, h, w, _ = images.shape
    gh, gw = h // p, w // p
    x = images[:, :gh * p, :gw * p, :].reshape(b, gh, p, gw, p, 3)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3), gh, gw


class DinoViT(nn.Module):
    """ViT trunk; forward returns the normed patch-token grid."""

    def __init__(self, cfg: DinoV2Config = VIT_S14, image_size: int = 224,
                 use_flash: bool = False):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        g = image_size // cfg.patch_size
        self.patch_embed = nn.Linear(cfg.patch_size * cfg.patch_size * 3, c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, c))
        self.blocks = nn.ModuleList(Block(cfg, use_flash)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(c, eps=cfg.ln_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] (ImageNet-normalised) -> [B, gh, gw, C]."""
        c = self.cfg.embed_dim
        patches, gh, gw = _patches(images, self.cfg.patch_size)
        x = self.patch_embed(patches)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, c)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 1:].reshape(x.shape[0], gh, gw, c)


def fast_forward(vit: DinoViT, images: torch.Tensor,
                 pair_blocks: Optional[bool] = None) -> torch.Tensor:
    """bf16 eval forward through the fused block op (the counterpart of
    the JAX fast_forward); returns fp32 features [B, gh, gw, C].
    pair_blocks: two blocks per op (fused_vit_block2, bit-equal) when the
    depth is even; None takes kernel_config.vit_pair_blocks_default()."""
    from ..ops.fused_vit_block import fused_vit_block, fused_vit_block2
    if pair_blocks is None:
        pair_blocks = vit_pair_blocks_default()
    c = vit.cfg
    bf = torch.bfloat16
    patches, gh, gw = _patches(images.to(bf), c.patch_size)
    x = F.linear(patches, vit.patch_embed.weight.to(bf),
                 vit.patch_embed.bias.to(bf))
    cls = vit.cls_token.to(bf).expand(x.shape[0], 1, c.embed_dim)
    x = torch.cat([cls, x], dim=1) + vit.pos_embed.to(bf)
    if pair_blocks and c.depth % 2 == 0:
        for i in range(0, c.depth, 2):
            x = fused_vit_block2(x, vit.blocks[i], vit.blocks[i + 1],
                                 num_heads=c.num_heads, eps=c.ln_eps)
    else:
        for blk in vit.blocks:
            x = fused_vit_block(x, blk, num_heads=c.num_heads, eps=c.ln_eps)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (xf - mean) * torch.rsqrt(var + c.ln_eps) * vit.norm.weight \
        + vit.norm.bias
    x = x.to(bf).float()
    return x[:, 1:].reshape(x.shape[0], gh, gw, c.embed_dim)


def extract_features(vit: DinoViT, images: torch.Tensor, *,
                     dtype=torch.float32, use_flash: bool = False
                     ) -> torch.Tensor:
    """Frozen forward: fp32 features [B, gh, gw, C]. bf16 with use_flash
    is the fused fast path (over the module's own parameters); otherwise
    the module runs as it is, on images cast to `dtype` (the caller keeps
    the module in that dtype)."""
    with torch.no_grad():
        if use_flash and dtype == torch.bfloat16:
            return fast_forward(vit, images)
        return vit(images.to(dtype)).float()
