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
products per call. A block is three launches: vit_qkv_kernel (LN1 and
the q / k / v projection, h kept on chip), vit_attn_kernel (each head's
attention over all 257 keys in one register pass, the head outputs kept
on chip as the operand of the projection, the LayerScale residual in its
epilogue: the fp32 x1) and vit_mlp_kernel (LN2, fc1, GELU and fc2 with
the LayerScale residual on tiles of 128 rows, the 1536-wide hidden kept
on chip); ops/kernels.py vit_qkv, vit_attn and vit_mlp. Only q / k / v
and x1 pass through device memory. Above 272 tokens (a 256 px image has
325, 518 px 1370), which vit_attn_kernel's score row does not hold, the
attention half after vit_qkv_kernel is attn_long_kernel on the q, k, v
columns (its keys streamed through shared memory, csrc/attn_long.cu)
and the GEMM with the projection's bias and the LayerScale residual in
its epilogue: four launches a block. The bf16 and fp32 forms of a block's
weights are made once per block module and kept until a parameter
changes.

Those kernels hold 384 channels in 6 heads. At any other trunk width
(DINOv2's ViT-B/14, 768 channels in 12 heads of 64, and ViT-L/14, 1024 in
16) a block is the wide route, five launches (ops/kernels.py
vit_attn_wide, vit_mlp_wide): vit_ln_gemm_kernel (csrc/vit_wide.cu: LN1
and the q / k / v projection), `attention` on the q, k, v columns
(attn_kernel; attn_long_kernel above 512 tokens), the GEMM with the
projection's bias and the LayerScale residual in its epilogue (the fp32
x1), vit_ln_gemm_kernel again (LN2, fc1 and GELU: the bf16 hidden), the
GEMM with fc2's bias and the LayerScale residual. Its rounding points
are the resident kernels', so fused_vit_block_plain is the plain version
of both routes; q / k / v, the attention output, x1 and the hidden pass
through device memory (keeping the hidden on chip at these widths is
later work). A width the route does not take (above 1024 channels, not a
multiple of 64, heads above 128 channels) is refused at build time
(ops/kernels.py width_misfits).

`fused_vit_block2` replaces the TPU kernel `fused_vit_block2`
(`_kernel2`) of the same file: two consecutive blocks in one op, the
intermediate rounded to bf16 between them, bit-equal to two calls of
fused_vit_block. On the TPU the gain was a token block that stayed in
VMEM across both blocks; here the pair is the two blocks' launches with
the intermediate stored as bf16 (6 launches): every kernel of the second
block reads it through bf16(x) as it would read the first block's
output, so the bits are those of two calls. The bound is twice the
single block's.

The wrappers run the kernels for a CUDA tensor and the plain PyTorch
version for a CPU tensor; `launches` and `launches2` count kernel runs
of the two ops.
"""

from __future__ import annotations

import torch

from . import fused_attn_block as FA
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
    w = {"n1w": n1w, "n1b": n1b, "wqkv": wqkv, "bqkv": bqkv, "wp": wp,
         "bp": bp, "ls1": ls1}
    qkv = FA.vit_qkv_plain(x, w, eps=eps)
    x1 = FA.vit_attn_plain(qkv, x, w, num_heads=num_heads,
                           out_dtype=torch.float32)
    h2 = plain.layer_norm(x1, n2w, n2b, eps)
    f = plain.gelu(plain.linear(h2, w1, b1))
    y = x1 + ls2.float() * plain.linear(f, w2, b2)
    return y.to(x.dtype)


def vit_ln_gemm_plain(x: torch.Tensor, g, be, w: torch.Tensor, bias, *,
                      eps: float, b_nk: bool = True, gelu: bool = False,
                      round_in: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ops/kernels.py vit_ln_gemm:
    bf16(act(bf16(LN(x)) . W + bias)) with fp32 LayerNorm statistics (of
    bf16(x) with round_in), exact GELU with gelu; W [N, C] (b_nk) or
    [C, N]. Returns bf16 [.., N]."""
    h = plain.layer_norm(plain.bf16(x) if round_in else x, g, be, eps)
    y = plain.linear(h, w if b_nk else w.t(), bias)
    return (plain.gelu(y) if gelu else y).to(torch.bfloat16)


def _prepare(blk) -> dict:
    """The block's weights as the kernels take them: bf16 matrices (torch
    Linear layout, so vit_mlp reads w1, w2 K-major), fp32 vectors."""
    (n1w, n1b, wqkv, bqkv, wp, bp, ls1, n2w, n2b, w1, b1, w2, b2,
     ls2) = _weights(blk)
    w16 = lambda w: w.detach().to(torch.bfloat16).contiguous()  # noqa: E731
    v32 = lambda v: v.detach().to(torch.float32).contiguous()  # noqa: E731
    return {"n1w": v32(n1w), "n1b": v32(n1b), "wqkv": w16(wqkv),
            "bqkv": v32(bqkv), "wp": w16(wp), "bp": v32(bp), "ls1": v32(ls1),
            "g": v32(n2w), "be": v32(n2b), "w1": w16(w1), "b1": v32(b1),
            "w2": w16(w2), "b2": v32(b2), "ls": v32(ls2), "kmajor": True}


def _fused_vit_block_cuda(x, blk, *, num_heads, eps, out_dtype=None):
    """The launches of one block: three at 384 channels in 6 heads, five
    on the wide route (the attention half's three, the MLP half's two).
    The result is stored as out_dtype (x.dtype by default)."""
    from . import kernels as K
    w = K.module_weights(blk, "_kernel_weights", _prepare)
    b, n, c = x.shape
    plan = K.vit_attn_plan(b, n, c, num_heads)
    mlp_wide = K.vit_mlp_plan(b * n, c, w["b1"].numel()).get("wide")
    x = x.contiguous()
    if plan.get("wide"):
        x1 = K.vit_attn_wide(x, w, num_heads=num_heads, eps=eps,
                             out_dtype=torch.float32)
    else:
        qkv = K.vit_qkv(x.view(b * n, c), w, eps=eps)
        x1 = K.vit_attn(qkv.view(b, n, 3 * c), x, w, out_dtype=torch.float32)
    x1 = x1.view(b * n, c)
    out_dtype = out_dtype or x.dtype
    if mlp_wide:
        y = K.vit_mlp_wide(x1, w, eps=eps, out_dtype=out_dtype)
    else:
        y, _ = K.vit_mlp(x1, w, eps=eps, out_dtype=out_dtype)
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
    mid = _fused_vit_block_cuda(x, blk_a, num_heads=num_heads, eps=eps,
                                out_dtype=torch.bfloat16)
    out = _fused_vit_block_cuda(mid, blk_b, num_heads=num_heads, eps=eps,
                                out_dtype=x.dtype)
    launches2 += 1
    return out
