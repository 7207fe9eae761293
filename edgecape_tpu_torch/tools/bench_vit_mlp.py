"""The ViT MLP kernel (csrc/kernels.cu vit_mlp_kernel, ops/kernels.py
vit_mlp) at the shapes the paths give it, on the GPU: kernel against
plain, device time, the card's bound and achieved TFLOP/s, and the chain
of three launches it replaced (LayerNorm, the fc1 GEMM with GELU in its
epilogue writing the [rows, F] bf16 hidden, the fc2 GEMM with the
LayerScale residual) on the same operands.

    python -m edgecape_tpu_torch.tools.bench_vit_mlp

One `[op] vit_mlp` line per shape. `device` is the time of the kernels one
call launches (torch.profiler, mean over REPS calls; tools/bench_attention
device_ms; "not measured" where the traces lost their device events).

Needs a CUDA device: the op launches the hand-written kernel.
"""

from __future__ import annotations

import sys

import torch

from ..ops import kernels as K
from ..ops import plain
from .bench_attention import ATOL, MEAN_TOL, PEAK_BF16_FLOPS, PEAK_BYTES_S, \
    RTOL, device_ms, ms_text, per_call
from .bench_attn_variants import card

C, F, EPS = K.VIT_C, 4 * K.VIT_C, 1e-6
# name, rows, x dtype, output dtype, weights K-major (torch Linear, the
# block's) or MN-major (the JAX layout, fused_ln_mlp's)
SHAPES = [
    ("block, query pass", 510 * 257, torch.float32, torch.bfloat16, True),
    ("block, support pass", 34 * 257, torch.float32, torch.bfloat16, True),
    ("block, training step", 32 * 257, torch.float32, torch.float32, True),
    ("fused_ln_mlp", 510 * 257, torch.bfloat16, torch.bfloat16, False),
]


def weights(dev, kmajor, seed=0):
    """vit_mlp's weight dict: bf16 matrices at 1 / sqrt(fan-in) in either
    layout, fp32 vectors, LayerScale 1 (every step shows in y)."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, s=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * s + shift).to(dev)

    w1, w2 = rn(F, C, s=C ** -0.5), rn(C, F, s=F ** -0.5)
    if not kmajor:
        w1, w2 = w1.t(), w2.t()
    return {"g": rn(C, s=0.1, shift=1.0), "be": rn(C, s=0.1),
            "w1": w1.to(torch.bfloat16).contiguous(), "b1": rn(F, s=0.1),
            "w2": w2.to(torch.bfloat16).contiguous(), "b2": rn(C, s=0.1),
            "ls": torch.ones(C, device=dev), "kmajor": kmajor}


def plain_mlp(x, w):
    w1, w2 = (w["w1"], w["w2"]) if w["kmajor"] else (w["w1"].t(), w["w2"].t())
    xf = x.float()
    h = plain.layer_norm(xf, w["g"], w["be"], EPS)
    f = plain.gelu(plain.linear(h, w1, w["b1"]))
    return xf + w["ls"] * plain.linear(f, w2, w["b2"])


def chain(x, w, out_dtype):
    """The three launches the kernel replaced."""
    _, h = K.layernorm(x, w["g"], w["be"], EPS, out_f32=False, out_bf16=True)
    b_nk = w["kmajor"]
    f = K.gemm(h, w["w1"], b_nk=b_nk, bias=w["b1"], act=K.ACT_GELU)
    return K.gemm(f, w["w2"], b_nk=b_nk, bias=w["b2"], res=x, ls=w["ls"],
                  out_dtype=out_dtype)


def run_case(spec, dev, power):
    name, rows, xdt, odt, kmajor = spec
    w = weights(dev, kmajor)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(rows, C, generator=g).to(dev).to(xdt)
    ref = plain_mlp(x, w).to(odt).float()
    y, _ = K.vit_mlp(x, w, eps=EPS, out_dtype=odt)
    torch.cuda.synchronize()
    d = (y.float() - ref).abs()
    excess = float((d - (ATOL + RTOL * ref.abs())).max())
    ok = excess <= 0 and float(d.mean()) <= MEAN_TOL and bool(
        torch.isfinite(y.float()).all())
    ms, per, wall, _ = per_call(lambda: K.vit_mlp(x, w, eps=EPS,
                                                  out_dtype=odt))
    chain_ms, chain_k, chain_wall = device_ms(lambda: chain(x, w, odt))
    flops = 2 * rows * 2 * C * F
    n_bytes = rows * C * (x.element_size() + torch.finfo(odt).bits // 8) \
        + 2 * 2 * C * F + 4 * (4 * C + F)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    print(f"[op] vit_mlp {name}: rows {rows}, C {C}, F {F}, x "
          f"{str(xdt).split('.')[-1]} -> {str(odt).split('.')[-1]}, "
          f"{'K' if kmajor else 'MN'}-major weights, "
          f"{K.vit_mlp_plan(rows, C, F)}: {ms_text(ms, wall)} in {per} "
          f"kernels, "
          f"{'%.1f' % (flops / ms / 1e9) if ms else 'not measured'} "
          f"TFLOP/s, bound "
          f"{max(t_bytes, t_ops) * 1e3:.4f} ms "
          f"({'bytes' if t_bytes > t_ops else 'operations'}); the chain it "
          f"replaced (layernorm, fc1 GEMM + GELU, fc2 GEMM + residual) "
          f"{ms_text(chain_ms, chain_wall)} in {chain_k} kernels; "
          f"max_abs_err "
          f"{float(d.max()):.4g} mean {float(d.mean()):.3g} (tol {ATOL} + "
          f"{RTOL:.4g}*|ref|, mean {MEAN_TOL}) {'OK' if ok else 'FAIL'} on "
          f"{power}", flush=True)
    return {"shape": name, "rows": rows, "ms": ms, "kernels": per,
            "chain_ms": chain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "max_abs_err": float(d.max()), "ok": ok}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_vit_mlp needs a CUDA device")
    dev = torch.device("cuda", 0)
    power = card()
    bad = [spec[0] for spec in SHAPES if not run_case(spec, dev, power)["ok"]]
    if bad:
        raise SystemExit(f"vit_mlp disagrees with plain at: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
