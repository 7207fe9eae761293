"""The ViT attention half's two kernels (csrc/kernels.cu vit_qkv_kernel and
vit_attn_kernel, ops/kernels.py vit_qkv and vit_attn) at the shapes the
paths give them, on the GPU: each kernel against its plain version, the
device time of each and of both, the card's bound and achieved TFLOP/s,
the chain of four launches they replaced (LayerNorm, the qkv GEMM,
attention in two register passes, the proj GEMM with the LayerScale
residual) on the same operands, and as a yardstick only SDPA with a
torch.matmul for the projection (the q / k / v views handed to SDPA are
made outside the timing).

At DINOv2's ViT-B/14 and ViT-L/14 widths (768 channels in 12 heads, 1024
in 16) the half is the wide route (ops/kernels.py vit_attn_wide:
vit_ln_gemm_kernel of csrc/vit_wide.cu for LN1 and q / k / v, the
attention, the projection GEMM): the half against its plain version and
its vit_ln_gemm_kernel alone (tools/bench_vit_mlp.py ln_gemm_case).

    python -m edgecape_tpu_torch.tools.bench_vit_attn

One `[op] vit_attn` line per shape, and at the wide widths one `[op]
vit_ln_gemm` line. `device` is the time of the kernels
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

EPS = 1e-6
# name, images, tokens, x dtype, output dtype, channels, heads: #1's query
# and support passes and the training step's frozen backbone (x1 fp32),
# #10 at the query pass (x.dtype); ViT-S/14 on vit_qkv_kernel and
# vit_attn_kernel, ViT-B/14 and ViT-L/14 on the wide route
SHAPES = [
    ("block, query pass", 510, 257, torch.bfloat16, torch.float32, 384, 6),
    ("block, support pass", 34, 257, torch.bfloat16, torch.float32, 384, 6),
    ("block, training step", 32, 257, torch.bfloat16, torch.float32, 384,
     6),
    ("fused_attn_block", 510, 257, torch.bfloat16, torch.bfloat16, 384, 6),
] + [(f"{trunk} block, {where}", b, 257, torch.bfloat16, torch.float32, c,
      h)
     for trunk, c, h in (("ViT-B", 768, 12), ("ViT-L", 1024, 16))
     for where, b in (("query pass", 510), ("support pass", 34),
                      ("training step", 32))]


def weights(dev, seed=0, c=K.VIT_C):
    """The kernels' weight dict at c channels: bf16 matrices at 1 /
    sqrt(fan-in) in torch Linear layout, fp32 vectors, LayerScale 1 (every
    step shows)."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, s=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * s + shift).to(dev)

    return {"n1w": rn(c, s=0.1, shift=1.0), "n1b": rn(c, s=0.1),
            "wqkv": rn(3 * c, c, s=c ** -0.5).to(torch.bfloat16),
            "bqkv": rn(3 * c, s=0.1),
            "wp": rn(c, c, s=c ** -0.5).to(torch.bfloat16), "bp": rn(c, s=0.1),
            "ls1": torch.ones(c, device=dev)}


def chain(x, w, out_dtype, h=K.VIT_HEADS):
    """The four launches the kernels replaced."""
    b, n, c = x.shape
    xb = x.reshape(b * n, c)
    _, hn = K.layernorm(xb, w["n1w"], w["n1b"], EPS, out_f32=False,
                        out_bf16=True)
    qkv = K.gemm(hn, w["wqkv"], b_nk=True, bias=w["bqkv"]).view(b, n, 3 * c)
    att = K.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                      num_heads=h, scale=1.0 / math.sqrt(c // h))
    return K.gemm(att.view(b * n, c), w["wp"], b_nk=True, bias=w["bp"],
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
    name, b, n, xdt, odt, c, h = spec
    w = weights(dev, c=c)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, n, c, generator=g).to(dev).to(xdt)
    xr = x.view(b * n, c)
    wide = (c, h) != (K.VIT_C, K.VIT_HEADS)
    if wide:
        qkv = FA.vit_qkv_plain(xr, w, eps=EPS)

        def call():
            return K.vit_attn_wide(x, w, num_heads=h, eps=EPS, out_dtype=odt)
        y = call()
        torch.cuda.synchronize()
        err_a, ok_a = 0.0, True
        err_b, ok_b = _check(y, FA.vit_attn_plain(qkv.view(b, n, 3 * c), x, w,
                                                  num_heads=h, out_dtype=odt))
    else:
        qkv = K.vit_qkv(xr, w, eps=EPS)

        def call():
            return K.vit_attn(K.vit_qkv(xr, w, eps=EPS).view(b, n, 3 * c), x,
                              w, out_dtype=odt)
        y = K.vit_attn(qkv.view(b, n, 3 * c), x, w, out_dtype=odt)
        torch.cuda.synchronize()
        err_a, ok_a = _check(qkv, FA.vit_qkv_plain(xr, w, eps=EPS))
        err_b, ok_b = _check(y, FA.vit_attn_plain(qkv.view(b, n, 3 * c), x, w,
                                                  num_heads=h, out_dtype=odt))
    del y
    ms, per, wall, _ = per_call(call)
    if wide:
        parts = "the wide route: vit_ln_gemm_kernel, attention, proj GEMM"
        chain_ms = None
        replaced = ("no four-launch chain at this width (layernorm_kernel "
                    "takes up to 512 channels)")
        ms_a = ms_b = None
    else:
        ms_a, per_a, wall_a, _ = per_call(lambda: K.vit_qkv(xr, w, eps=EPS))
        ms_b, per_b, wall_b, _ = per_call(lambda: K.vit_attn(
            qkv.view(b, n, 3 * c), x, w, out_dtype=odt))
        parts = (f"vit_qkv {ms_text(ms_a, wall_a)} in {per_a}, vit_attn "
                 f"{ms_text(ms_b, wall_b)} in {per_b}")
        chain_ms, chain_k, chain_wall = device_ms(lambda: chain(x, w, odt))
        replaced = (f"the chain it replaced (layernorm, qkv GEMM, attention, "
                    f"proj GEMM + residual) {ms_text(chain_ms, chain_wall)} "
                    f"in {chain_k} kernels")
    q, k, v = (qkv.view(b, n, 3, h, c // h)[:, :, i].transpose(1, 2)
               for i in range(3))
    wpt = w["wp"].t()
    lib_ms, _, lib_wall = device_ms(lambda: torch.matmul(
        F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(
            b * n, c), wpt))
    del q, k, v
    rows = b * n
    flops = 2 * rows * c * 4 * c + 4 * b * n * n * c
    n_bytes = rows * c * (x.element_size() + torch.finfo(odt).bits // 8) \
        + 2 * 4 * c * c + 4 * 7 * c
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    ok = ok_a and ok_b
    print(f"[op] vit_attn {name}: [{b}, {n}, {c}], {h} heads, x "
          f"{str(xdt).split('.')[-1]} -> {str(odt).split('.')[-1]}, "
          f"{K.vit_attn_plan(b, n, c, h)}: {ms_text(ms, wall)} in {per} "
          f"kernels ({parts}), "
          f"{'%.1f' % (flops / ms / 1e9) if ms else 'not measured'} "
          f"TFLOP/s, bound {bound_ms:.4f} ms "
          f"({'bytes' if t_bytes > t_ops else 'operations'}); {replaced}; "
          f"yardstick SDPA + torch.matmul proj {ms_text(lib_ms, lib_wall)}; "
          f"max_abs_err "
          f"{'' if wide else f'vit_qkv {err_a:.4g}, '}"
          f"{'the half' if wide else 'vit_attn'} {err_b:.4g} (tol {ATOL} + "
          f"{RTOL:.4g}*|ref|, mean {MEAN_TOL}) {'OK' if ok else 'FAIL'} on "
          f"{power}", flush=True)
    row = {"shape": name, "images": b, "tokens": n, "c": c, "heads": h,
           "ms": ms, "kernels": per, "vit_qkv_ms": ms_a, "vit_attn_ms": ms_b,
           "chain_ms": chain_ms, "sdpa_matmul_ms": lib_ms,
           "bound_ms": bound_ms, "max_abs_err": max(err_a, err_b), "ok": ok}
    if wide:
        from .bench_vit_mlp import ln_gemm_case
        row["ln_gemm"] = ln_gemm_case(f"qkv, {name}", xr, w["n1w"], w["n1b"],
                                      w["wqkv"], w["bqkv"], power,
                                      round_in=True)
        row["ok"] = ok and row["ln_gemm"]["ok"]
    return row


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
