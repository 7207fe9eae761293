"""The ViT attention half's two kernels (csrc/kernels.cu vit_qkv_kernel and
vit_attn_kernel, ops/kernels.py vit_qkv and vit_attn) at the shapes the
paths give them, on the GPU: each kernel against its plain version, the
device time of each and of both, the card's bound and achieved TFLOP/s,
the chain of four launches they replaced (LayerNorm, the qkv GEMM,
attention in two register passes, the proj GEMM with the LayerScale
residual) on the same operands, and as a yardstick only SDPA with a
torch.matmul for the projection (the q / k / v views handed to SDPA are
made outside the timing).

    python -m edgecape_tpu_torch.tools.bench_vit_attn

One `[op] vit_attn` line per shape. `device` is the time of the kernels
one call launches (torch.profiler, mean over REPS calls; tools/
bench_attention device_ms: where the traces lose device events, "not
measured" beside the CUDA-event wall time, host gaps included, and the
kernel count from the wrappers' launch counters).

Needs a CUDA device: the ops launch the hand-written kernels.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from ..ops import fused_attn_block as FA
from ..ops import kernels as K
from .bench_attention import ATOL, MEAN_TOL, PEAK_BF16_FLOPS, PEAK_BYTES_S, \
    RTOL, device_ms, ms_text, per_call
from .bench_attn_variants import card

C, H, EPS = K.VIT_C, K.VIT_HEADS, 1e-6
# name, images, tokens, x dtype, output dtype: #1's query and support
# passes and the training step's frozen backbone (x1 fp32), #10 at the
# query pass (x.dtype)
SHAPES = [
    ("block, query pass", 510, 257, torch.bfloat16, torch.float32),
    ("block, support pass", 34, 257, torch.bfloat16, torch.float32),
    ("block, training step", 32, 257, torch.bfloat16, torch.float32),
    ("fused_attn_block", 510, 257, torch.bfloat16, torch.bfloat16),
]


def weights(dev, seed=0):
    """The kernels' weight dict: bf16 matrices at 1 / sqrt(fan-in) in
    torch Linear layout, fp32 vectors, LayerScale 1 (every step shows)."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, s=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * s + shift).to(dev)

    return {"n1w": rn(C, s=0.1, shift=1.0), "n1b": rn(C, s=0.1),
            "wqkv": rn(3 * C, C, s=C ** -0.5).to(torch.bfloat16),
            "bqkv": rn(3 * C, s=0.1),
            "wp": rn(C, C, s=C ** -0.5).to(torch.bfloat16), "bp": rn(C, s=0.1),
            "ls1": torch.ones(C, device=dev)}


def chain(x, w, out_dtype):
    """The four launches the kernels replaced."""
    b, n, _ = x.shape
    xb = x.reshape(b * n, C)
    _, h = K.layernorm(xb, w["n1w"], w["n1b"], EPS, out_f32=False,
                       out_bf16=True)
    qkv = K.gemm(h, w["wqkv"], b_nk=True, bias=w["bqkv"]).view(b, n, 3 * C)
    att = K.attention(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                      num_heads=H, scale=1.0 / math.sqrt(C // H))
    return K.gemm(att.view(b * n, C), w["wp"], b_nk=True, bias=w["bp"],
                  res=xb.to(torch.bfloat16), ls=w["ls1"],
                  out_dtype=out_dtype)


def _check(out, ref):
    """(max error, worst excess over ATOL + RTOL |ref|, within bounds)."""
    d = (out.float() - ref.float()).abs()
    excess = float((d - (ATOL + RTOL * ref.float().abs())).max())
    ok = excess <= 0 and float(d.mean()) <= MEAN_TOL and bool(
        torch.isfinite(out.float()).all())
    return float(d.max()), ok


def run_case(spec, dev, power):
    name, b, n, xdt, odt = spec
    w = weights(dev)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, n, C, generator=g).to(dev).to(xdt)
    xr = x.view(b * n, C)
    qkv = K.vit_qkv(xr, w, eps=EPS)
    y = K.vit_attn(qkv.view(b, n, 3 * C), x, w, out_dtype=odt)
    torch.cuda.synchronize()
    err_a, ok_a = _check(qkv, FA.vit_qkv_plain(xr, w, eps=EPS))
    err_b, ok_b = _check(y, FA.vit_attn_plain(qkv.view(b, n, 3 * C), x, w,
                                              num_heads=H, out_dtype=odt))
    ms_a, per_a, wall_a, _ = per_call(lambda: K.vit_qkv(xr, w, eps=EPS))
    ms_b, per_b, wall_b, _ = per_call(lambda: K.vit_attn(
        qkv.view(b, n, 3 * C), x, w, out_dtype=odt))
    ms, per, wall, _ = per_call(lambda: K.vit_attn(
        K.vit_qkv(xr, w, eps=EPS).view(b, n, 3 * C), x, w, out_dtype=odt))
    chain_ms, chain_k, chain_wall = device_ms(lambda: chain(x, w, odt))
    q, k, v = (qkv.view(b, n, 3, H, C // H)[:, :, i].transpose(1, 2)
               for i in range(3))
    wpt = w["wp"].t()
    lib_ms, _, lib_wall = device_ms(lambda: torch.matmul(
        F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
            b * n, C), wpt))
    rows = b * n
    flops = 2 * rows * C * 4 * C + 4 * b * n * n * C
    n_bytes = rows * C * (x.element_size() + torch.finfo(odt).bits // 8) \
        + 2 * 4 * C * C + 4 * 7 * C
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    ok = ok_a and ok_b
    print(f"[op] vit_attn {name}: [{b}, {n}, {C}], {H} heads, x "
          f"{str(xdt).split('.')[-1]} -> {str(odt).split('.')[-1]}, "
          f"{K.vit_attn_plan(b, n, C, H)}: {ms_text(ms, wall)} in {per} "
          f"kernels (vit_qkv {ms_text(ms_a, wall_a)} in {per_a}, vit_attn "
          f"{ms_text(ms_b, wall_b)} in {per_b}), "
          f"{'%.1f' % (flops / ms / 1e9) if ms else 'not measured'} "
          f"TFLOP/s, bound {bound_ms:.4f} ms "
          f"({'bytes' if t_bytes > t_ops else 'operations'}); the chain it "
          f"replaced (layernorm, qkv GEMM, attention, proj GEMM + residual) "
          f"{ms_text(chain_ms, chain_wall)} in {chain_k} kernels; yardstick "
          f"SDPA + torch.matmul proj {ms_text(lib_ms, lib_wall)}; max_abs_err "
          f"vit_qkv "
          f"{err_a:.4g}, vit_attn {err_b:.4g} (tol {ATOL} + {RTOL:.4g}*|ref|,"
          f" mean {MEAN_TOL}) {'OK' if ok else 'FAIL'} on {power}",
          flush=True)
    return {"shape": name, "images": b, "tokens": n, "ms": ms,
            "kernels": per, "vit_qkv_ms": ms_a, "vit_attn_ms": ms_b,
            "chain_ms": chain_ms, "sdpa_matmul_ms": lib_ms,
            "bound_ms": bound_ms, "max_abs_err": max(err_a, err_b),
            "ok": ok}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_vit_attn needs a CUDA device")
    dev = torch.device("cuda", 0)
    power = card()
    bad = [spec[0] for spec in SHAPES if not run_case(spec, dev, power)["ok"]]
    if bad:
        raise SystemExit(f"vit_qkv / vit_attn disagree with plain at: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
