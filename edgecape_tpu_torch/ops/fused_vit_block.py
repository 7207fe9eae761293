"""One pre-norm DINOv2 block, and two consecutive blocks, as chains of
hand-written CUDA launches.

Replaces the TPU kernel `edgecape_tpu/ops/fused_vit_block.py:
fused_vit_block` (`_kernel`, `_block_body`): LN1 -> q/k/v -> softmax
attention -> proj -> LayerScale residual -> LN2 -> fc1 -> GELU -> fc2 ->
LayerScale residual, bf16 matmuls with fp32 accumulation, fp32 LN
statistics, q/k/v and the attention output stored as bf16, the residual
kept fp32 inside the block. One difference by design: GELU is the exact
erf form of the model and of upstream DINOv2 (the TPU kernel used the tanh
approximation because Mosaic has no erf).

On the H100 the block is bound by its matmuls: at the query pass's
[510, 257, 384], 464 GFLOP of qkv/proj/fc1/fc2 and 52 GFLOP of attention
products per call; the activation round trips between launches (x, qkv,
att, x1, h2 and the 1536-wide MLP hidden all go through device memory)
come second. The design keeps each product on tensor cores (WMMA bf16 tiles,
ops/kernels.gemm), fuses bias, GELU and the LayerScale residual into the
GEMM epilogues so no separate elementwise pass exists, and keeps all 257
keys and values of a head resident in shared memory for the attention.
Fusing the block into one launch (wgmma + TMA, the MLP hidden kept on
chip) is later work.

`fused_vit_block2` replaces the TPU kernel `fused_vit_block2`
(`_kernel2`) of the same file: two consecutive blocks in one op, the
intermediate rounded to bf16 between them, bit-equal to two calls of
fused_vit_block. On the TPU the gain was a token block that stayed in
VMEM across both blocks; here the two blocks' launches are enqueued back
to back over one set of activation buffers (normed tokens, qkv,
attention output, fp32 residual, MLP hidden), so the pair allocates once
and its second block finds its buffers where the first left them. The
bound is twice the single block's.

The wrappers run the kernels for a CUDA tensor and the plain PyTorch
version for a CPU tensor; `launches` and `launches2` count kernel runs
of the two ops.
"""

from __future__ import annotations

import math

import torch

from . import plain

launches = 0
launches2 = 0


def _weights(blk):
    at = blk.attn
    return (blk.norm1.weight, blk.norm1.bias, at.qkv.weight, at.qkv.bias,
            at.proj.weight, at.proj.bias, blk.ls1, blk.norm2.weight,
            blk.norm2.bias, blk.mlp_fc1.weight, blk.mlp_fc1.bias,
            blk.mlp_fc2.weight, blk.mlp_fc2.bias, blk.ls2)


def fused_vit_block_plain(x: torch.Tensor, blk, *, num_heads: int,
                          eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x [B, N, C] -> [B, N, C] in x.dtype."""
    (n1w, n1b, wqkv, bqkv, wp, bp, ls1, n2w, n2b, w1, b1, w2, b2,
     ls2) = _weights(blk)
    c = x.shape[-1]
    d = c // num_heads
    xf = plain.bf16(x)
    h = plain.layer_norm(xf, n1w, n1b, eps)
    qkv = plain.bf16(plain.linear(h, wqkv, bqkv))
    att = plain.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                          num_heads=num_heads, scale=1.0 / math.sqrt(d))
    x1 = xf + ls1.float() * plain.linear(att, wp, bp)
    h2 = plain.layer_norm(x1, n2w, n2b, eps)
    f = plain.gelu(plain.linear(h2, w1, b1))
    y = x1 + ls2.float() * plain.linear(f, w2, b2)
    return y.to(x.dtype)


def _buffers(b, n, c, f_dim, device):
    """One set of activation buffers of a block: normed tokens, qkv,
    attention output, fp32 residual, MLP hidden."""
    bf = torch.bfloat16
    r = b * n
    return {"h": torch.empty((r, c), dtype=bf, device=device),
            "qkv": torch.empty((r, 3 * c), dtype=bf, device=device),
            "att": torch.empty((b, n, c), dtype=bf, device=device),
            "x1": torch.empty((r, c), dtype=torch.float32, device=device),
            "f": torch.empty((r, f_dim), dtype=bf, device=device)}


def _fused_vit_block_cuda(x, blk, *, num_heads, eps, out_dtype=None,
                          bufs=None):
    """The launches of one block; the result is stored as out_dtype
    (x.dtype by default). bufs: a set of activation buffers to work in
    (_buffers), else each launch allocates its own output."""
    from . import kernels as K
    (n1w, n1b, wqkv, bqkv, wp, bp, ls1, n2w, n2b, w1, b1, w2, b2,
     ls2) = _weights(blk)
    w16 = lambda w: w.detach().to(torch.bfloat16)  # noqa: E731
    b, n, c = x.shape
    d = c // num_heads
    buf = (bufs or {}).get
    xb = x.to(torch.bfloat16).reshape(b * n, c).contiguous()
    _, h = K.layernorm(xb, n1w, n1b, eps, out_f32=False,
                       out_bf16=True if bufs is None else bufs["h"])
    qkv = K.gemm(h, w16(wqkv), b_nk=True, bias=bqkv,
                 out=buf("qkv")).view(b, n, 3 * c)
    att = K.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                      num_heads=num_heads, scale=1.0 / math.sqrt(d),
                      out=buf("att"))
    x1 = K.gemm(att.view(b * n, c), w16(wp), b_nk=True, bias=bp, res=xb,
                ls=ls1, out_dtype=torch.float32, out=buf("x1"))
    _, h2 = K.layernorm(x1, n2w, n2b, eps, out_f32=False,
                        out_bf16=True if bufs is None else bufs["h"])
    f = K.gemm(h2, w16(w1), b_nk=True, bias=b1, act=K.ACT_GELU,
               out=buf("f"))
    y = K.gemm(f, w16(w2), b_nk=True, bias=b2, res=x1, ls=ls2,
               out_dtype=out_dtype or x.dtype)
    return y.view(b, n, c)


def fused_vit_block(x: torch.Tensor, blk, *, num_heads: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """x1 = x + ls1 * proj(MHA(LN1(x))); y = x1 + ls2 * MLP(LN2(x1)).
    x: [B, N, C]; blk: a models.dinov2.Block. Returns x.dtype."""
    global launches
    if not x.is_cuda:
        return fused_vit_block_plain(x, blk, num_heads=num_heads, eps=eps)
    out = _fused_vit_block_cuda(x, blk, num_heads=num_heads, eps=eps)
    launches += 1
    return out


def fused_vit_block2_plain(x: torch.Tensor, blk_a, blk_b, *, num_heads: int,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the pair: the first block's result
    rounded to bf16, then the second block; x.dtype out."""
    mid = fused_vit_block_plain(x, blk_a, num_heads=num_heads, eps=eps)
    return fused_vit_block_plain(mid.to(torch.bfloat16).to(x.dtype), blk_b,
                                 num_heads=num_heads, eps=eps)


def fused_vit_block2(x: torch.Tensor, blk_a, blk_b, *, num_heads: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """blk_b(bf16(blk_a(x))): two consecutive blocks, bit-equal to two
    calls of fused_vit_block. x: [B, N, C]; returns x.dtype."""
    global launches2
    if not x.is_cuda:
        return fused_vit_block2_plain(x, blk_a, blk_b, num_heads=num_heads,
                                      eps=eps)
    b, n, c = x.shape
    bufs = _buffers(b, n, c, blk_a.mlp_fc1.weight.shape[0], x.device)
    mid = _fused_vit_block_cuda(x, blk_a, num_heads=num_heads, eps=eps,
                                out_dtype=torch.bfloat16, bufs=bufs)
    out = _fused_vit_block_cuda(mid, blk_b, num_heads=num_heads, eps=eps,
                                out_dtype=x.dtype, bufs=bufs)
    launches2 += 1
    return out
