"""LayerNorm + MLP + LayerScale residual, the second half of a ViT block,
as a chain of hand-written CUDA launches.

Replaces the TPU kernel `edgecape_tpu/ops/fused_mlp.py:fused_ln_mlp`
(`_kernel`): y = x + ls * (gelu(LN(x) W1 + b1) W2 + b2), bf16 matmul
operands with fp32 accumulation, fp32 LayerNorm statistics, the hidden
activations rounded to bf16, the residual taken from x as it was given
(not rounded), the result stored in x.dtype. That last rounding is what
separates this op from the same half inside fused_vit_block, which keeps
the first half's result in fp32. One difference by design: GELU is the
exact erf form of the model (the TPU kernel used the tanh approximation
because Mosaic has no erf; the reference function beside it uses erf).

On the H100 the op is bound by its two matmuls (at [510, 257, 384] with
F = 1536: 309 GFLOP, 0.31 ms at the bf16 peak, against 0.2 GB of x in
and out); the [rows, F] hidden activations go through device memory once
between the two GEMMs. The design puts bias and GELU into the first
GEMM's epilogue and bias, LayerScale and the residual into the second's,
so the chain is LayerNorm, GEMM, GEMM.

Weights are laid out as the JAX function takes them: w1 [C, F], w2
[F, C]. The wrapper runs the kernels for a CUDA tensor and the plain
PyTorch version for a CPU tensor; `launches` counts kernel runs.
"""

from __future__ import annotations

import torch

from . import plain

launches = 0


def fused_ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, layerscale, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x [..., N, C] -> the same shape, x.dtype."""
    xf = x.to(torch.float32)
    h = plain.layer_norm(xf, ln_scale, ln_bias, eps)
    f = plain.gelu(plain.linear(h, w1.t(), b1))
    g = plain.linear(f, w2.t(), b2)
    return (xf + layerscale.to(torch.float32) * g).to(x.dtype)


def _fused_ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, layerscale, *,
                       eps):
    from . import kernels as K
    bf = torch.bfloat16
    c = x.shape[-1]
    xt = x.reshape(-1, c).contiguous()
    _, h = K.layernorm(xt, ln_scale, ln_bias, eps, out_f32=False,
                       out_bf16=True)
    f = K.gemm(h, w1.detach().to(bf), b_nk=False, bias=b1, act=K.ACT_GELU)
    y = K.gemm(f, w2.detach().to(bf), b_nk=False, bias=b2, res=xt,
               ls=layerscale, out_dtype=x.dtype)
    return y.view(x.shape)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, layerscale, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """y = x + layerscale * (gelu(LN(x) @ w1 + b1) @ w2 + b2).
    x: [..., N, C] fp32 or bf16; w1 [C, F]; w2 [F, C]."""
    global launches
    if not x.is_cuda:
        return fused_ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                                  layerscale, eps=eps)
    out = _fused_ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2,
                             layerscale, eps=eps)
    launches += 1
    return out
