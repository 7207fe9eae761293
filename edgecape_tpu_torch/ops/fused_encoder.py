"""Joint-encoder layer and stack as chains of hand-written CUDA launches.

Replaces the TPU kernels `edgecape_tpu/ops/fused_encoder.py:
fused_encoder_layer` / `fused_encoder_stack` (`_run`, `_kernel`,
`_layer_body`): src = bf16(x + pos) feeds q, k, v and the residual;
key-masked multi-head self-attention; post-norm LN1; ReLU FFN; LN2. The
stack is this layer run once per layer with the bf16 rounding between
layers that the TPU stack performs in-register, so its output is the
TPU stack's.

On the H100 a layer is three launches: the q, k, v GEMM against the
concatenated weight, attention with all keys and values of a head in
shared memory (the [N, N] scores never leave the SM), and
enc_post_kernel (ops/kernels.py enc_post; enc_post_wide_kernel at a
width other than 256 channels up to 512), which runs everything after
the attention on tiles of 128 token rows kept on chip: out projection,
residual and LN1, the ReLU FFN with its hidden in shared memory one
chunk of 128 at a time, LN2 (see csrc/kernels.cu for its design). The
stack adds the position once; each layer's kernel writes the next
layer's src = bf16(bf16(y) + pos) beside (or, before the last layer,
instead of) its output, so the stack is 1 + 3 L launches. Above 512
channels, where a tile's rows no longer fit on chip, the post-attention
half takes the split route (ops/kernels.py post_plan): the out
projection, the FFN's two products as GEMMs whose epilogues add the bias,
the ReLU and the residual, each LayerNorm a layernorm_kernel launch and
the next src an add_pos_kernel one, the activations between them in
device memory, so a layer is 7 launches (8 before the last layer) and the
stack 1 + 8 L - 1. The bf16 and
concatenated weights are made once per layer module and kept until a
parameter changes.

The wrappers run the kernels for CUDA tensors and the plain PyTorch
versions for CPU tensors; `launches` counts layer runs on the card (in
the stack too) and `stack_launches` stack runs.
"""

from __future__ import annotations

import math

import torch

from . import plain

launches = 0
stack_launches = 0


def _weights(layer):
    at = layer.self_attn
    return (at.q_proj, at.k_proj, at.v_proj, at.out_proj, layer.norm1,
            layer.linear1, layer.linear2, layer.norm2)


def fused_encoder_layer_plain(tokens, pos, key_valid, layer, *,
                              num_heads: int, eps: float = 1e-5):
    """Plain PyTorch version. tokens [B, N, C]; pos [N, C]; key_valid
    [B, N] bool. Returns [B, N, C] in tokens.dtype."""
    qp, kp, vp, op, n1, l1, l2, n2 = _weights(layer)
    c = tokens.shape[-1]
    d = c // num_heads
    src = plain.bf16(plain.bf16(tokens) + plain.bf16(pos)[None])
    q = plain.linear(src, qp.weight, qp.bias)
    k = plain.linear(src, kp.weight, kp.bias)
    v = plain.linear(src, vp.weight, vp.bias)
    att = plain.attention(q, k, v, num_heads=num_heads,
                          scale=1.0 / math.sqrt(d),
                          kb=plain.key_bias(key_valid))
    att = plain.linear(att, op.weight, op.bias)
    x = plain.layer_norm(src + att, n1.weight, n1.bias, eps)
    f = torch.relu(plain.linear(x, l1.weight, l1.bias))
    f2 = plain.linear(f, l2.weight, l2.bias)
    return plain.layer_norm(x + f2, n2.weight, n2.bias, eps).to(tokens.dtype)


def _prepare(layer) -> dict:
    """The layer's weights as the kernels take them, in the layout of
    ops/kernels.py post_plan: the FFN hidden padded to its chunks and, at
    a width other than 256, wo, w1 and w2 padded to enc_post_wide_kernel's
    c_pad channels and f_pad hidden columns (zero rows and columns,
    pad_ffn / pad_cols)."""
    from . import kernels as K
    at = layer.self_attn
    w16 = lambda w: w.detach().to(torch.bfloat16).contiguous()  # noqa: E731
    v32 = lambda v: v.detach().to(torch.float32).contiguous()  # noqa: E731
    c, f = layer.linear1.in_features, layer.linear1.out_features
    plan = K.post_plan(1, c, f)
    cp = plan.get("c_pad", c)
    w1, b1, w2 = K.pad_ffn(layer.linear1.weight, layer.linear1.bias,
                           layer.linear2.weight, plan.get("f_pad", f), cp)
    return {
        "wqkv": w16(torch.cat([at.q_proj.weight, at.k_proj.weight,
                               at.v_proj.weight])),
        "bqkv": v32(torch.cat([at.q_proj.bias, at.k_proj.bias,
                               at.v_proj.bias])),
        "wo": w16(K.pad_cols(at.out_proj.weight, cp, cp)),
        "bo": v32(at.out_proj.bias),
        "g1": v32(layer.norm1.weight), "be1": v32(layer.norm1.bias),
        "w1": w16(w1), "b1": v32(b1), "w2": w16(w2),
        "b2": v32(layer.linear2.bias),
        "g2": v32(layer.norm2.weight), "be2": v32(layer.norm2.bias)}


def _layer_cuda(src, b, n, key_valid, layer, *, num_heads, eps, out_dtype,
                pos):
    """One layer on the card from its src [B N, C] bf16 (position added):
    three launches. Returns enc_post's (y or None, next src or None)."""
    global launches
    from . import kernels as K
    w = K.module_weights(layer, "_kernel_weights", _prepare)
    c = src.shape[-1]
    qkv = K.gemm(src, w["wqkv"], b_nk=True, bias=w["bqkv"]).view(b, n, 3 * c)
    att = K.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                      num_heads=num_heads,
                      scale=1.0 / math.sqrt(c // num_heads),
                      key_valid=key_valid)
    out = K.enc_post(att.view(b * n, c), src, w, eps=eps, out_dtype=out_dtype,
                     pos=pos)
    launches += 1
    return out


def fused_encoder_layer(tokens, pos, key_valid, layer, *, num_heads: int,
                        eps: float = 1e-5):
    """Post-norm encoder layer, position into q/k/v and the residual.
    layer: a models.transformer.EncoderLayer."""
    if not tokens.is_cuda:
        return fused_encoder_layer_plain(tokens, pos, key_valid, layer,
                                         num_heads=num_heads, eps=eps)
    from . import kernels as K
    b, n, c = tokens.shape
    src = K.add_pos(tokens, pos).view(b * n, c)
    out, _ = _layer_cuda(src, b, n, key_valid, layer, num_heads=num_heads,
                         eps=eps, out_dtype=tokens.dtype, pos=None)
    return out.view(b, n, c)


def fused_encoder_stack(tokens, pos, key_valid, layers, *, num_heads: int,
                        eps: float = 1e-5):
    """The whole encoder: each layer's output, in tokens.dtype, feeds the
    next (bf16-rounded when tokens are bf16, as in the TPU stack)."""
    global stack_launches
    if not tokens.is_cuda or not layers:
        x = tokens
        for layer in layers:
            x = fused_encoder_layer(x, pos, key_valid, layer,
                                    num_heads=num_heads, eps=eps)
        return x
    out = _stack_cuda(tokens, pos, key_valid, layers, num_heads=num_heads,
                      eps=eps)
    stack_launches += 1
    return out


def _stack_cuda(tokens, pos, key_valid, layers, *, num_heads, eps):
    from . import kernels as K
    b, n, c = tokens.shape
    src = K.add_pos(tokens, pos).view(b * n, c)
    posb = pos.to(torch.bfloat16).contiguous()
    for i, layer in enumerate(layers):
        last = i == len(layers) - 1
        out, src = _layer_cuda(src, b, n, key_valid, layer,
                               num_heads=num_heads, eps=eps,
                               out_dtype=tokens.dtype if last else None,
                               pos=None if last else posb)
    return out.view(b, n, c)
