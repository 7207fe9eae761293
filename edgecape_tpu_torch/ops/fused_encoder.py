"""Joint-encoder layer and stack as chains of hand-written CUDA launches.

Replaces the TPU kernels `edgecape_tpu/ops/fused_encoder.py:
fused_encoder_layer` / `fused_encoder_stack` (`_run`, `_kernel`,
`_layer_body`): src = bf16(x + pos) feeds q, k, v and the residual;
key-masked multi-head self-attention; post-norm LN1; ReLU FFN; LN2. The
stack is this layer run once per layer with the bf16 rounding between
layers that the TPU stack performs in-register, so its output is the
TPU stack's.

On the H100, at [510 rows, 356 tokens, 256 channels] per layer, the layer
is bound by memory traffic more than by its ~95 GFLOP: each launch
boundary moves a [510*356, 256..768] activation through device memory.
The design folds bias, ReLU and the fp32 residual into GEMM epilogues,
adds the residual inside the LayerNorm kernel, computes q, k and v in one
GEMM against the concatenated weight, and runs attention with all 356
keys and values of a head in shared memory so the [356, 356] scores never
leave the SM. One launch per layer (and the token block resident across
layers) is later work.

The wrappers run the kernels for CUDA tensors and the plain PyTorch
versions for CPU tensors; `launches` counts layer-kernel runs and
`stack_launches` stack runs.
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


def _fused_encoder_layer_cuda(tokens, pos, key_valid, layer, *, num_heads,
                              eps):
    from . import kernels as K
    qp, kp, vp, op, n1, l1, l2, n2 = _weights(layer)
    w16 = lambda w: w.detach().to(torch.bfloat16)  # noqa: E731
    b, n, c = tokens.shape
    d = c // num_heads
    src = K.add_pos(tokens, pos).view(b * n, c)
    wqkv = torch.cat([w16(qp.weight), w16(kp.weight), w16(vp.weight)])
    bqkv = torch.cat([qp.bias, kp.bias, vp.bias])
    qkv = K.gemm(src, wqkv, b_nk=True, bias=bqkv).view(b, n, 3 * c)
    att = K.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                      num_heads=num_heads, scale=1.0 / math.sqrt(d),
                      key_valid=key_valid)
    a = K.gemm(att.view(b * n, c), w16(op.weight), b_nk=True, bias=op.bias,
               out_dtype=torch.float32)
    x, xb = K.layernorm(src, n1.weight, n1.bias, eps, r=a, out_bf16=True)
    f = K.gemm(xb, w16(l1.weight), b_nk=True, bias=l1.bias, act=K.ACT_RELU)
    f2 = K.gemm(f, w16(l2.weight), b_nk=True, bias=l2.bias,
                out_dtype=torch.float32)
    out_f32 = tokens.dtype == torch.float32
    yf, yb = K.layernorm(x, n2.weight, n2.bias, eps, r=f2, out_f32=out_f32,
                         out_bf16=not out_f32)
    return (yf if out_f32 else yb).view(b, n, c).to(tokens.dtype)


def fused_encoder_layer(tokens, pos, key_valid, layer, *, num_heads: int,
                        eps: float = 1e-5):
    """Post-norm encoder layer, position into q/k/v and the residual.
    layer: a models.transformer.EncoderLayer."""
    global launches
    if not tokens.is_cuda:
        return fused_encoder_layer_plain(tokens, pos, key_valid, layer,
                                         num_heads=num_heads, eps=eps)
    out = _fused_encoder_layer_cuda(tokens, pos, key_valid, layer,
                                    num_heads=num_heads, eps=eps)
    launches += 1
    return out


def fused_encoder_stack(tokens, pos, key_valid, layers, *, num_heads: int,
                        eps: float = 1e-5):
    """The whole encoder: each layer's output, in tokens.dtype, feeds the
    next (bf16-rounded when tokens are bf16, as in the TPU stack)."""
    global stack_launches
    x = tokens
    for layer in layers:
        x = fused_encoder_layer(x, pos, key_valid, layer,
                                num_heads=num_heads, eps=eps)
    if tokens.is_cuda:
        stack_launches += 1
    return x
