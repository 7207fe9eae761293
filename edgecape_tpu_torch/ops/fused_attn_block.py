"""LayerNorm + multi-head self-attention + projection + LayerScale
residual, the first half of a ViT block, as two hand-written CUDA
launches.

Replaces the TPU kernel `edgecape_tpu/ops/fused_attn_block.py:
fused_attn_block` (`_kernel`): y = x + ls * proj(MHA(LN(x))), with x
rounded to bf16 on entry, bf16 matmul operands with fp32 accumulation,
fp32 LayerNorm statistics and softmax, q / k / v, the probabilities and
the attention output rounded to bf16, and the result stored in x.dtype
(inside fused_vit_block the same half stays fp32 for the second half).

On the H100, at [510, 257, 384] with 6 heads, the op is bound by its
matmuls: 155 GFLOP of qkv and proj and 52 GFLOP of attention products
per call. It is two launches (ops/kernels.py vit_qkv and vit_attn,
csrc/kernels.cu vit_qkv_kernel and vit_attn_kernel): LN1 and the q / k /
v projection on tiles of 128 rows with h kept on chip, then for 128
query rows of an image at a time the attention of each head over all
its keys in one register pass, the head outputs kept on chip as the
operand of the projection, and bias, LayerScale and the residual in its
epilogue. Only q, k and v pass through device memory. The same two
kernels are the first half of fused_vit_block; above 272 tokens the
second is attn_long_kernel and the GEMM (ops/kernels.py vit_attn). At any
other width than 384 channels in 6 heads the op is the wide route's three
launches (ops/kernels.py vit_attn_wide): vit_ln_gemm_kernel
(csrc/vit_wide.cu: LN and the q / k / v projection), `attention` on the
q, k, v columns, the GEMM with bias, LayerScale and the residual.

Weights are laid out as the JAX function takes them: wq, wk, wv, wproj
[C, C] applied as `h @ w`; their bf16 [out, in] forms (the three
projections as one matrix) and fp32 vectors are made once and kept while
the source tensors are unchanged. The wrapper runs the kernels for a
CUDA tensor and the plain PyTorch version for a CPU tensor; `launches`
counts kernel runs.
"""

from __future__ import annotations

import math

import torch

from . import plain

launches = 0
_KEEP = 8
_prepared: dict = {}    # ids of the sources -> (sources, versions, weights)


def _torch_layout(ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj, bproj,
                  layerscale) -> dict:
    """The JAX function's weights in the layout of the kernels and of
    fused_vit_block's modules: [wq | wk | wv]^T and wproj^T as [out, in]
    matrices (torch Linear layout), the three biases as one vector."""
    return {"n1w": ln_scale, "n1b": ln_bias,
            "wqkv": torch.cat([wq, wk, wv], dim=1).t(),
            "bqkv": torch.cat([bq, bk, bv]), "wp": wproj.t(), "bp": bproj,
            "ls1": layerscale}


def fused_attn_block_plain(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv,
                           wproj, bproj, layerscale, *, num_heads: int,
                           eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x [B, N, C] -> [B, N, C] in x.dtype."""
    w = _torch_layout(ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj, bproj,
                      layerscale)
    return vit_attn_plain(vit_qkv_plain(x, w, eps=eps), x, w,
                          num_heads=num_heads, out_dtype=x.dtype)


def vit_qkv_plain(x: torch.Tensor, w: dict, *, eps: float) -> torch.Tensor:
    """Plain PyTorch version of kernels.vit_qkv: bf16(bf16(LN(bf16(x))) .
    wqkv^T + bqkv), bf16 [..., 3 C]. w: n1w, n1b, wqkv [3 C, C] (torch
    Linear layout), bqkv."""
    h = plain.layer_norm(plain.bf16(x), w["n1w"], w["n1b"], eps)
    return plain.linear(h, w["wqkv"], w["bqkv"]).to(torch.bfloat16)


def vit_attn_plain(qkv: torch.Tensor, x: torch.Tensor, w: dict, *,
                   num_heads: int, out_dtype) -> torch.Tensor:
    """Plain PyTorch version of kernels.vit_attn: bf16(x) + ls1 * (att .
    wp^T + bp) with att the attention over qkv [B, N, 3 C] (q | k | v), in
    out_dtype. w: wp [C, C] (torch Linear layout), bp, ls1."""
    c = x.shape[-1]
    att = plain.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                          num_heads=num_heads,
                          scale=1.0 / math.sqrt(c // num_heads))
    o = plain.linear(att, w["wp"], w["bp"])
    return (plain.bf16(x) + w["ls1"].to(torch.float32) * o).to(out_dtype)


def _kernel_weights(*src) -> dict:
    """The weights as kernels.vit_qkv and vit_attn take them: _torch_layout
    with bf16 matrices and fp32 vectors, contiguous; made once and kept
    (for the last _KEEP sets) until a source tensor is replaced or written
    in place. src: fused_attn_block's weight arguments in order."""
    key = tuple(id(t) for t in src)
    versions = tuple(t._version for t in src)
    hit = _prepared.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], src)) \
            and hit[1] == versions:
        return hit[2]
    w = {k: v.detach().to(torch.bfloat16 if v.dim() == 2 else torch.float32)
         .contiguous() for k, v in _torch_layout(*src).items()}
    if len(_prepared) >= _KEEP:
        _prepared.pop(next(iter(_prepared)))
    _prepared[key] = (src, versions, w)
    return w


def fused_attn_block(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj,
                     bproj, layerscale, *, num_heads: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """y = x + layerscale * proj(MHA(LN(x))). x: [B, N, C] fp32 or bf16."""
    global launches
    if not x.is_cuda:
        return fused_attn_block_plain(
            x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj, bproj,
            layerscale, num_heads=num_heads, eps=eps)
    from . import kernels as K
    b, n, c = x.shape
    plan = K.vit_attn_plan(b, n, c, num_heads)
    w = _kernel_weights(ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wproj,
                        bproj, layerscale)
    x = x.contiguous()
    if plan.get("wide"):
        out = K.vit_attn_wide(x, w, num_heads=num_heads, eps=eps,
                              out_dtype=x.dtype)
    else:
        qkv = K.vit_qkv(x.view(b * n, c), w, eps=eps)
        out = K.vit_attn(qkv.view(b, n, 3 * c), x, w, out_dtype=x.dtype)
    launches += 1
    return out
