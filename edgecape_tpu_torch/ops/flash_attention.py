"""Fused multi-head attention with a key mask, as a hand-written CUDA
kernel (ops/kernels.attention).

Replaces the TPU kernel `edgecape_tpu/ops/flash_attention.py:flash_mha`
(`_attn_kernel`, `_kernel_with_bias`): softmax(q k^T / sqrt(D) + key
mask) v with bf16 operands (fp32 callers are rounded at the load), fp32
softmax, probabilities rounded to bf16 before P.V, the output rounded to
bf16 and returned in the caller's dtype.

On the H100 the eval path calls it on the skeleton refine layers'
keypoint self-attention ([34 x 8 heads, 100 x 100, D=32]): a tiny,
latency-bound problem. The design gives each (row, head) one block that
reads q/k/v straight from the [B, N, H*D] projections (no head transpose
or bf16 cast pass), keeps all keys and values in shared memory, and runs
both products on tensor cores (WMMA); the scores never reach device
memory.

The wrapper runs the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; `launches` counts kernel runs.
"""

from __future__ import annotations

import math

from . import plain

launches = 0


def flash_mha_plain(q, k, v, key_valid=None):
    """Plain PyTorch version. q [B, Nq, H, D]; k/v [B, Nk, H, D];
    key_valid [B, Nk] bool or None. Returns [B, Nq, H, D] in q.dtype."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    kb = None if key_valid is None else plain.key_bias(key_valid)
    out = plain.attention(q.reshape(b, nq, h * d), k.reshape(b, nk, h * d),
                          v.reshape(b, nk, h * d), num_heads=h,
                          scale=1.0 / math.sqrt(d), kb=kb)
    return out.reshape(b, nq, h, d).to(q.dtype)


def flash_mha(q, k, v, key_valid=None):
    """softmax(q k^T / sqrt(D) + key mask) v, as the TPU kernel computes
    it (see the module docstring)."""
    global launches
    if not q.is_cuda:
        return flash_mha_plain(q, k, v, key_valid)
    from . import kernels as K
    launches += 1
    b, nq, h, d = q.shape
    nk = k.shape[1]
    kb = None if key_valid is None else plain.key_bias(key_valid)
    out = K.attention(q.reshape(b, nq, h * d), k.reshape(b, nk, h * d),
                      v.reshape(b, nk, h * d), num_heads=h,
                      scale=1.0 / math.sqrt(d), key_bias=kb,
                      out_dtype=q.dtype)
    return out.reshape(b, nq, h, d)
