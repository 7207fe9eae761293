"""Plain PyTorch forms of the CUDA building blocks (ops/kernels.py), with
the same rounding points: bf16 operands, fp32 accumulation, fp32
LayerNorm statistics and softmax, probabilities rounded to bf16 before
P.V, attention output rounded to bf16.

Each fused op's plain version is written with these; the op takes it for
a CPU tensor, and chip_smoke.py holds the kernels against it on the
card."""

from __future__ import annotations

import math
from typing import Optional

import torch

BF16 = torch.bfloat16


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in fp32."""
    return t.to(BF16).to(torch.float32)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16(x) @ bf16(w)^T + b in fp32; w is a torch Linear weight
    [out, in]. Products of bf16 values are exact in fp32, so this is the
    bf16 GEMM with fp32 accumulation."""
    y = torch.matmul(bf16(x), bf16(w).t())
    return y if b is None else y + b.to(torch.float32)


def layer_norm(x: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    """fp32 LayerNorm with the two-pass variance of the JAX kernels."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * gamma.to(torch.float32)
            + beta.to(torch.float32))


def key_bias(valid: torch.Tensor) -> torch.Tensor:
    """bool [B, Nk] -> additive fp32 mask (0 valid, -inf invalid)."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, -math.inf))


def attention(q, k, v, *, num_heads: int, scale: float, kb=None,
              bias=None) -> torch.Tensor:
    """[B, N, H*D] operands -> [B, Nq, H*D] fp32 holding bf16 values:
    softmax(bf16(q) bf16(k)^T * scale + kb + bias) rounded to bf16, times
    bf16(v), rounded to bf16."""
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    qh = bf16(q).reshape(b, nq, num_heads, d).transpose(1, 2)
    kh = bf16(k).reshape(b, nk, num_heads, d).transpose(1, 2)
    vh = bf16(v).reshape(b, nk, num_heads, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale       # [B, H, Nq, Nk]
    if kb is not None:
        s = s + kb[:, None, None, :]
    if bias is not None:
        s = s + bias.to(torch.float32)
    p = bf16(torch.softmax(s, dim=-1))
    o = bf16(torch.matmul(p, vh))
    return o.transpose(1, 2).reshape(b, nq, c)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))
