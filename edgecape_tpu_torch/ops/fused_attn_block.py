"""LayerNorm + multi-head self-attention + projection + LayerScale
residual, the first half of a ViT block, as a chain of hand-written CUDA
launches.

Replaces the TPU kernel `edgecape_tpu/ops/fused_attn_block.py:
fused_attn_block` (`_kernel`): y = x + ls * proj(MHA(LN(x))), with x
rounded to bf16 on entry, bf16 matmul operands with fp32 accumulation,
fp32 LayerNorm statistics and softmax, q / k / v, the probabilities and
the attention output rounded to bf16, and the result stored in x.dtype
(inside fused_vit_block the same half stays fp32 for the second half).

On the H100, at [510, 257, 384] with 6 heads, the op is bound by its
matmuls: 155 GFLOP of qkv and proj and 52 GFLOP of attention products
per call. The design is that of fused_vit_block's first half: the three
projections as one GEMM over the concatenated weight, the attention
kernel with a head's 257 keys and values resident in shared memory, and
bias, LayerScale and the residual in the projection GEMM's epilogue.

Weights are laid out as the JAX function takes them: wq, wk, wv, wproj
[C, C] applied as `h @ w`. The wrapper runs the kernels for a CUDA tensor
and the plain PyTorch version for a CPU tensor; `launches` counts kernel
runs.
"""

from __future__ import annotations

import math

import torch

from . import plain

launches = 0


def fused_attn_block_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv,
                           wproj, bproj, layerscale, *, num_heads: int,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x [B, N, C] -> [B, N, C] in x.dtype."""
    d = x.shape[-1] // num_heads
    xf = plain.bf16(x)
    h = plain.layer_norm(xf, ln_scale, ln_bias, eps)
    q = plain.linear(h, wq.t(), bq)
    k = plain.linear(h, wk.t(), bk)
    v = plain.linear(h, wv.t(), bv)
    att = plain.attention(q, k, v, num_heads=num_heads,
                          scale=1.0 / math.sqrt(d))
    o = plain.linear(att, wproj.t(), bproj)
    return (xf + layerscale.to(torch.float32) * o).to(x.dtype)


def _fused_attn_block_cuda(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv,
                           wproj, bproj, layerscale, *, num_heads, eps):
    from . import kernels as K
    bf = torch.bfloat16
    b, n, c = x.shape
    d = c // num_heads
    xb = x.to(bf).reshape(b * n, c).contiguous()
    _, h = K.layernorm(xb, ln_scale, ln_bias, eps, out_f32=False,
                       out_bf16=True)
    wqkv = torch.cat([wq, wk, wv], dim=1).detach().to(bf)      # [C, 3C]
    qkv = K.gemm(h, wqkv, b_nk=False,
                 bias=torch.cat([bq, bk, bv])).view(b, n, 3 * c)
    att = K.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                      num_heads=num_heads, scale=1.0 / math.sqrt(d))
    y = K.gemm(att.view(b * n, c), wproj.detach().to(bf), b_nk=False,
               bias=bproj, res=xb, ls=layerscale, out_dtype=x.dtype)
    return y.view(b, n, c)


def fused_attn_block(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj,
                     bproj, layerscale, *, num_heads: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """y = x + layerscale * proj(MHA(LN(x))). x: [B, N, C] fp32 or bf16."""
    global launches
    if not x.is_cuda:
        return fused_attn_block_plain(
            x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj, bproj,
            layerscale, num_heads=num_heads, eps=eps)
    out = _fused_attn_block_cuda(
        x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj, bproj,
        layerscale, num_heads=num_heads, eps=eps)
    launches += 1
    return out
