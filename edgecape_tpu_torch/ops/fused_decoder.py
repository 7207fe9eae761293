"""One graph-decoder layer as a chain of hand-written CUDA launches.

Replaces the TPU kernel `edgecape_tpu/ops/fused_decoder.py:
fused_decoder_layer` (`_kernel`), eval mode:
(1) keypoint self-attention with the key mask and the additive Markov
    bias [B, H, K, K], then LN1;
(2) cross-attention with q = [x; qpos] and k = [img; img_pos] at 2C,
    v = img, out_proj (2C, rounded to bf16) and the choker 2C -> C, then
    LN2;
(3) GCN: a linear to [K, 2, F] contracted with adj [B, 2, K, K] (both
    slices summed in fp32), ReLU, ffn2, then LN3.
Rounding points follow the TPU kernel: bf16 matmul operands with fp32
accumulation, fp32 LN statistics and softmax, bf16 q/k/v and attention
outputs, the adjacency rounded to bf16 for its contraction.

On the H100, at [510 rows, K=100, 256 image tokens, C=256], the layer is
bound by the cross-attention's key/value projections (2 x [510*256, 512]
outputs) and by launch count: the per-row tensors are small. The design
never materialises the concatenations: [x; qpos] @ Wq is two GEMMs whose
second adds the first in its epilogue, and the img_pos half of the key
projection is computed once per call ([256, 512]) and added to every row
in the key GEMM's epilogue. The adjacency contraction is a strided
batched GEMM over rows on tensor cores with the second slice accumulating
onto the first and ReLU fused. A single launch per layer is later work.

The wrapper runs the kernels for a CUDA tensor and the plain PyTorch
version for a CPU tensor; `launches` counts kernel runs.
"""

from __future__ import annotations

import torch

from . import plain

launches = 0


def fused_decoder_layer_plain(x, query_pos, img_tokens, img_pos, kp_valid,
                              bias, adj, layer, *, num_heads: int,
                              eps: float = 1e-5):
    """Plain PyTorch version. x/query_pos [B, K, C]; img_tokens [B, HW, C];
    img_pos [HW, C]; kp_valid [B, K] bool; bias [B, H, K, K]; adj
    [B, 2, K, K]; layer: a models.transformer.DecoderLayer. Returns
    [B, K, C] in x.dtype."""
    sa, ca = layer.self_attn, layer.cross_attn
    c = x.shape[-1]
    d, d2 = c // num_heads, 2 * c // num_heads
    xb = plain.bf16(x)
    q = plain.linear(xb, sa.q_proj.weight, sa.q_proj.bias)
    k = plain.linear(xb, sa.k_proj.weight, sa.k_proj.bias)
    v = plain.linear(xb, sa.v_proj.weight, sa.v_proj.bias)
    att = plain.attention(q, k, v, num_heads=num_heads, scale=d ** -0.5,
                          kb=plain.key_bias(kp_valid), bias=bias)
    att = plain.linear(att, sa.out_proj.weight, sa.out_proj.bias)
    x1 = plain.layer_norm(xb + att, layer.norm1.weight, layer.norm1.bias,
                          eps)

    img = plain.bf16(img_tokens)
    ipos = plain.bf16(img_pos)[None].expand(img.shape[0], -1, -1)
    qc = torch.cat([x1, query_pos.to(torch.float32)], dim=-1)
    kc = torch.cat([img, ipos], dim=-1)
    q2 = plain.linear(qc, ca.q_proj.weight, ca.q_proj.bias)
    k2 = plain.linear(kc, ca.k_proj.weight, ca.k_proj.bias)
    v2 = plain.linear(img, ca.v_proj.weight, ca.v_proj.bias)
    att2 = plain.attention(q2, k2, v2, num_heads=num_heads, scale=d2 ** -0.5)
    att2 = plain.bf16(plain.linear(att2, ca.out_proj.weight,
                                   ca.out_proj.bias))
    att2 = plain.linear(att2, layer.choker.weight, layer.choker.bias)
    x2 = plain.layer_norm(x1 + att2, layer.norm2.weight, layer.norm2.bias,
                          eps)

    y = plain.bf16(plain.linear(x2, layer.gcn.conv.weight,
                                layer.gcn.conv.bias))
    f_dim = y.shape[-1] // 2
    a = plain.bf16(adj)
    m = (torch.matmul(a[:, 0], y[..., :f_dim])
         + torch.matmul(a[:, 1], y[..., f_dim:]))
    f = plain.linear(torch.relu(m), layer.ffn2.weight, layer.ffn2.bias)
    return plain.layer_norm(x2 + f, layer.norm3.weight, layer.norm3.bias,
                            eps).to(x.dtype)


def _fused_decoder_layer_cuda(x, query_pos, img_tokens, img_pos, kp_valid,
                              bias, adj, layer, *, num_heads, eps):
    from . import kernels as K
    sa, ca = layer.self_attn, layer.cross_attn
    w16 = lambda w: w.detach().to(torch.bfloat16)  # noqa: E731
    f32 = torch.float32
    b, k, c = x.shape
    hw = img_tokens.shape[1]
    d, d2 = c // num_heads, 2 * c // num_heads

    # (1) biased, key-masked self-attention + LN1
    xb = x.to(torch.bfloat16).reshape(b * k, c).contiguous()
    wqkv = torch.cat([w16(sa.q_proj.weight), w16(sa.k_proj.weight),
                      w16(sa.v_proj.weight)])
    bqkv = torch.cat([sa.q_proj.bias, sa.k_proj.bias, sa.v_proj.bias])
    qkv = K.gemm(xb, wqkv, b_nk=True, bias=bqkv).view(b, k, 3 * c)
    att = K.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                      num_heads=num_heads, scale=d ** -0.5,
                      key_bias=plain.key_bias(kp_valid), bias=bias)
    a = K.gemm(att.view(b * k, c), w16(sa.out_proj.weight), b_nk=True,
               bias=sa.out_proj.bias, out_dtype=f32)
    x1, x1b = K.layernorm(xb, layer.norm1.weight, layer.norm1.bias, eps,
                          r=a, out_bf16=True)

    # (2) concat-position cross-attention, out_proj, choker, LN2
    img = img_tokens.to(torch.bfloat16).contiguous()
    qp = query_pos.to(torch.bfloat16).reshape(b * k, c).contiguous()
    ipos = img_pos.to(torch.bfloat16).contiguous()
    wq, wk = w16(ca.q_proj.weight), w16(ca.k_proj.weight)
    tq = K.gemm(x1b, wq[:, :c], b_nk=True, out_dtype=f32)
    q2 = K.gemm(qp, wq[:, c:], b_nk=True, bias=ca.q_proj.bias, pre=tq)
    kpos = K.gemm(ipos, wk[:, c:], b_nk=True, bias=ca.k_proj.bias,
                  out_dtype=f32)                               # [HW, 2C]
    k2 = K.gemm(img, wk[:, :c], b_nk=True, pre=kpos)           # [B, HW, 2C]
    v2 = K.gemm(img.view(b * hw, c), w16(ca.v_proj.weight), b_nk=True,
                bias=ca.v_proj.bias).view(b, hw, 2 * c)
    att2 = K.attention(q2.view(b, k, 2 * c), k2, v2, num_heads=num_heads,
                       scale=d2 ** -0.5)
    o2 = K.gemm(att2.view(b * k, 2 * c), w16(ca.out_proj.weight), b_nk=True,
                bias=ca.out_proj.bias)
    a2 = K.gemm(o2, w16(layer.choker.weight), b_nk=True,
                bias=layer.choker.bias, out_dtype=f32)
    x2, x2b = K.layernorm(x1, layer.norm2.weight, layer.norm2.bias, eps,
                          r=a2, out_bf16=True)

    # (3) GCN over the 2-slice adjacency, ffn2, LN3
    y = K.gemm(x2b, w16(layer.gcn.conv.weight), b_nk=True,
               bias=layer.gcn.conv.bias)
    f_dim = y.shape[-1] // 2
    y = y.view(b, k, 2 * f_dim)
    adjb = adj.to(torch.bfloat16).contiguous()
    m0 = K.gemm(adjb[:, 0], y[..., :f_dim], b_nk=False, out_dtype=f32)
    f = K.gemm(adjb[:, 1], y[..., f_dim:], b_nk=False, pre=m0,
               act=K.ACT_RELU)
    f2 = K.gemm(f.view(b * k, f_dim), w16(layer.ffn2.weight), b_nk=True,
                bias=layer.ffn2.bias, out_dtype=f32)
    out_f32 = x.dtype == torch.float32
    of, ob = K.layernorm(x2, layer.norm3.weight, layer.norm3.bias, eps, r=f2,
                         out_f32=out_f32, out_bf16=not out_f32)
    return (of if out_f32 else ob).view(b, k, c).to(x.dtype)


def fused_decoder_layer(x, query_pos, img_tokens, img_pos, kp_valid, bias,
                        adj, layer, *, num_heads: int, eps: float = 1e-5):
    """One graph-decoder layer (see the module docstring)."""
    global launches
    if not x.is_cuda:
        return fused_decoder_layer_plain(
            x, query_pos, img_tokens, img_pos, kp_valid, bias, adj, layer,
            num_heads=num_heads, eps=eps)
    out = _fused_decoder_layer_cuda(
        x, query_pos, img_tokens, img_pos, kp_valid, bias, adj, layer,
        num_heads=num_heads, eps=eps)
    launches += 1
    return out
