"""The GEMM behind the fused ops at the shapes the eval and training
paths give it, on the GPU: both hand-written mainloops against a float64
reference, their times, the card's bound and `torch.matmul` beside them.

    python -m edgecape_tpu_torch.tools.bench_gemm

One `[op] gemm` line per shape: the error of the mainloop the dispatch
picks (`ops/kernels.py gemm_mainloop`), CUDA-event medians of the TMA +
wgmma mainloop and of the thread-copy + WMMA one (where the operands allow
both), TFLOP/s of the picked one, the bound (operands read once, the
output written once, over the memory rate; or the products over the bf16
rate) and the time of one `torch.matmul` on the same operands, which
nothing in the package calls. The big shapes' operands and outputs exceed
the 50 MB L2, and calls are timed back to back, as the fused ops launch
them.

Needs a CUDA device: the GEMM has no CPU form.
"""

from __future__ import annotations

import sys

import torch

from ..ops import kernels as K
from ..ops import plain
from .bench_attention import PEAK_BF16_FLOPS, PEAK_BYTES_S, time_ms
from .bench_attn_variants import card

# fp32 outputs within 1e-4 relative of the float64 product of the bf16
# operands, bf16 outputs within an ulp of it (2^-8 relative)
F32_TOL, BF16_TOL = 1e-4, 2.0 ** -8

# name, batch (None: 2-D), M, N, K, B as [N, K], epilogue, output dtype
SHAPES = [
    ("vit qkv", None, 510 * 257, 1152, 384, True, "bias", torch.bfloat16),
    ("vit proj", None, 510 * 257, 384, 384, True, "res_ls", torch.float32),
    ("vit fc1", None, 510 * 257, 1536, 384, True, "gelu", torch.bfloat16),
    ("vit fc2", None, 510 * 257, 384, 1536, True, "res_ls", torch.bfloat16),
    ("vit qkv, training", None, 32 * 257, 1152, 384, True, "bias",
     torch.bfloat16),
    ("encoder qkv", None, 510 * 356, 768, 256, True, "bias", torch.bfloat16),
    ("encoder out proj", None, 510 * 356, 256, 256, True, "bias",
     torch.float32),
    ("encoder ffn1", None, 510 * 356, 384, 256, True, "relu",
     torch.bfloat16),
    ("encoder ffn2", None, 510 * 356, 256, 384, True, "bias", torch.float32),
    ("decoder qkv", None, 510 * 100, 768, 256, True, "bias", torch.bfloat16),
    ("decoder cross k", 510, 256, 512, 256, True, "pre", torch.bfloat16),
    ("decoder gcn adjacency", 510, 100, 384, 100, False, "relu_pre",
     torch.bfloat16),
    ("decoder kpt_branch out", None, 510 * 100, 2, 256, True, "bias",
     torch.float32),
    ("mlp fc1, B as [K, N]", None, 510 * 257, 1536, 384, False, "gelu",
     torch.bfloat16),
]


def reference(a, b, b_nk, bias, pre, act, res, ls):
    """The epilogue of the float64 product of the bf16 operands."""
    y = a.double() @ (b.double().transpose(-1, -2) if b_nk else b.double())
    if bias is not None:
        y = y + bias.double()
    if pre is not None:
        y = y + pre.double()
    if act == K.ACT_GELU:
        y = plain.gelu(y)
    elif act == K.ACT_RELU:
        y = torch.relu(y)
    if res is not None:
        y = res.double() + (ls.double() if ls is not None else 1.0) * y
    return y


def make_case(spec, dev, seed=0):
    name, z, m, n, k, b_nk, epi, out_dtype = spec
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    lead = () if z is None else (z,)
    a = rn(*lead, m, k).to(bf)
    b = (rn(n, k) if b_nk else rn(*lead, k, n)) * k ** -0.5
    b = b.to(bf)
    kw = {"bias": None, "pre": None, "act": K.ACT_NONE, "res": None,
          "ls": None}
    if epi in ("bias", "gelu", "relu", "res_ls"):
        kw["bias"] = rn(n, s=0.1)
    if epi == "gelu":
        kw["act"] = K.ACT_GELU
    if epi in ("relu", "relu_pre"):
        kw["act"] = K.ACT_RELU
    if epi == "pre":
        kw["pre"] = rn(m, n)                     # shared across the batch
    if epi == "relu_pre":
        kw["pre"] = rn(*lead, m, n)
    if epi == "res_ls":
        kw["res"], kw["ls"] = rn(*lead, m, n), rn(n)
    return a, b, kw


def check(out, ref):
    """(max abs error, within the tolerance of the output dtype)."""
    tol = F32_TOL if out.dtype == torch.float32 else BF16_TOL
    diff = (out.double() - ref).abs()
    ok = bool((diff <= tol * (1.0 + ref.abs())).all()) and bool(
        torch.isfinite(out).all())
    return diff.max().item(), ok


def bound_ms(a, b, out, kw):
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (a, b, out, kw["bias"], kw["pre"], kw["res"],
                            kw["ls"]) if t is not None)
    flops = 2.0 * out.numel() * a.shape[-1]
    t_b, t_o = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations", flops


def _part(t, zi, rows):
    """Batch entry zi (of a batched tensor) and the given rows of t."""
    if t is None:
        return None
    return (t[zi] if t.dim() == 3 else t)[rows]


def run_case(spec, dev, power) -> dict:
    name, z, m, n, k, b_nk, _, out_dtype = spec
    a, b, kw = make_case(spec, dev)
    # checked against float64: the first rows of the first batch entry and
    # the last rows of the last (the ragged edge of M)
    parts = [(0, slice(0, 4096)), (-1, slice(-300, None))]
    with torch.no_grad():
        refs = [reference(_part(a, zi, rows), b[zi] if b.dim() == 3 else b,
                          b_nk, kw["bias"], _part(kw["pre"], zi, rows),
                          kw["act"], _part(kw["res"], zi, rows), kw["ls"])
                for zi, rows in parts]
        picked = K.gemm_mainloop(
            n, z or 1, (a.data_ptr(), a.stride(-2), a.stride(0) if z else 0),
            (b.data_ptr(), b.stride(-2), b.stride(0) if b.dim() == 3 else 0))
        times, errs, ok = {}, {}, True
        out = None
        for loop, label in ((K.GEMM_TMA, "tma"), (K.GEMM_COPY, "copy")):
            if loop == K.GEMM_TMA and picked != K.GEMM_TMA:
                continue
            out = K.gemm(a, b, b_nk=b_nk, out_dtype=out_dtype, mainloop=loop,
                         **kw)
            torch.cuda.synchronize()
            errs[label] = 0.0
            for (zi, rows), ref in zip(parts, refs):
                err, good = check(_part(out, zi, rows), ref)
                errs[label] = max(errs[label], err)
                ok = ok and good
            times[label] = time_ms(
                lambda: K.gemm(a, b, b_nk=b_nk, out_dtype=out_dtype,
                               mainloop=loop, **kw))
        bt = b.transpose(-1, -2) if b_nk else b
        lib_ms = time_ms(lambda: torch.matmul(a, bt))
        bnd, by, flops = bound_ms(a, b, out, kw)
    label = "tma" if picked == K.GEMM_TMA else "copy"
    row = {"name": name, "shape": [z or 1, m, n, k], "b_nk": b_nk,
           "mainloop": label, "ok": ok, "max_abs_err": errs[label],
           "ms": times[label], "tma_ms": times.get("tma"),
           "copy_ms": times["copy"], "tflops": flops / times[label] / 1e9,
           "bound_ms": bnd, "bound_by": by, "matmul_ms": lib_ms}
    tma = "none (operands)" if "tma" not in times else f"{times['tma']:.4f}"
    print(f"[op] gemm {name}: [Z {z or 1}, M {m}, N {n}, K {k}] B as "
          f"{'[N, K]' if b_nk else '[K, N]'} -> {str(out_dtype)[6:]}, "
          f"mainloop {label}: max_abs_err {errs[label]:.4g} vs float64 (tol "
          f"{F32_TOL if out_dtype == torch.float32 else BF16_TOL:.3g} "
          f"relative), TMA + wgmma {tma} ms, thread-copy + WMMA "
          f"{times['copy']:.4f} ms, {row['tflops']:.1f} TFLOP/s, bound "
          f"{bnd:.4f} ms ({by}), torch.matmul {lib_ms:.4f} ms (no epilogue) "
          f"on {power} {'OK' if ok else 'FAIL'}", flush=True)
    return row


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("usage: bench_gemm")
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm needs a CUDA device")
    dev, power = torch.device("cuda", 0), card()
    rows = []
    for spec in SHAPES:
        rows.append(run_case(spec, dev, power))
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"gemm disagrees with the float64 reference: {bad}")
    return rows


if __name__ == "__main__":
    main()
