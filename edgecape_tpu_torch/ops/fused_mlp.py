"""LayerNorm + MLP + LayerScale residual, the second half of a ViT block,
as one hand-written CUDA launch.

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
and out). It is one launch of vit_mlp_kernel (ops/kernels.py vit_mlp,
csrc/kernels.cu), which runs LayerNorm, fc1, GELU and fc2 on tiles of
128 rows with the [rows, F] hidden kept on chip in chunks of 64 columns.
At any other width than 384 channels it is the wide route's two launches
(ops/kernels.py vit_mlp_wide): vit_ln_gemm_kernel (csrc/vit_wide.cu: LN,
fc1, bias, GELU; the bf16 hidden stored) and the GEMM with fc2's bias,
LayerScale and the residual in its epilogue, both reading the weights in
this layout.

Weights are laid out as the JAX function takes them, w1 [C, F] and w2
[F, C], and read so by the kernel (no transposed copy). Weights that are
not bf16 are cast once and the cast kept while the source tensor is
unchanged. The wrapper runs the kernel for a CUDA tensor and the plain
PyTorch version for a CPU tensor; `launches` counts kernel runs.
"""

from __future__ import annotations

import torch

from . import plain

launches = 0
_CAST_KEEP = 8
_casts: dict = {}       # id(source) -> (source, its version, bf16 copy)


def fused_ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, layerscale, *,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version: x [..., N, C] -> the same shape, x.dtype."""
    xf = x.to(torch.float32)
    h = plain.layer_norm(xf, ln_scale, ln_bias, eps)
    f = plain.gelu(plain.linear(h, w1.t(), b1))
    g = plain.linear(f, w2.t(), b2)
    return (xf + layerscale.to(torch.float32) * g).to(x.dtype)


def _bf16(w: torch.Tensor) -> torch.Tensor:
    """w as a contiguous bf16 matrix: w itself when it is one, else a cast
    made once and kept (for the last _CAST_KEEP sources) until w is
    written in place."""
    if w.dtype == torch.bfloat16 and w.is_contiguous():
        return w.detach()
    hit = _casts.get(id(w))
    if hit is not None and hit[0] is w and hit[1] == w._version:
        return hit[2]
    cast = w.detach().to(torch.bfloat16).contiguous()
    if len(_casts) >= _CAST_KEEP:
        _casts.pop(next(iter(_casts)))
    _casts[id(w)] = (w, w._version, cast)
    return cast


def _fused_ln_mlp_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2, layerscale, *,
                       eps):
    from . import kernels as K
    c = x.shape[-1]
    w = {"g": ln_scale, "be": ln_bias, "w1": _bf16(w1), "b1": b1,
         "w2": _bf16(w2), "b2": b2, "ls": layerscale}
    w = {k: K._f32(v) if v.dim() == 1 else v for k, v in w.items()}
    w["kmajor"] = False
    rows = x.reshape(-1, c).contiguous()
    if K.vit_mlp_plan(rows.shape[0], c, w["b1"].numel()).get("wide"):
        y = K.vit_mlp_wide(rows, w, eps=eps, out_dtype=x.dtype)
    else:
        y, _ = K.vit_mlp(rows, w, eps=eps, out_dtype=x.dtype)
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
