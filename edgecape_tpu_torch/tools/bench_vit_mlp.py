"""The ViT MLP half at the shapes the paths give it, on the GPU: at 384
channels the MLP kernel (csrc/kernels.cu vit_mlp_kernel, ops/kernels.py
vit_mlp), kernel against plain, device time, the card's bound and
achieved TFLOP/s, and the chain of three launches it replaced (LayerNorm,
the fc1 GEMM with GELU in its epilogue writing the [rows, F] bf16 hidden,
the fc2 GEMM with the LayerScale residual) on the same operands; at
DINOv2's ViT-B/14 and ViT-L/14 widths (768 and 1024 channels) the wide
route (ops/kernels.py vit_mlp_wide: vit_ln_gemm_kernel of csrc/vit_wide.cu
for LN2, fc1 and GELU, then the GEMM), the half against plain and its
vit_ln_gemm_kernel alone (`ln_gemm_case`).

    python -m edgecape_tpu_torch.tools.bench_vit_mlp
    python -m edgecape_tpu_torch.tools.bench_vit_mlp --splits

One `[op] vit_mlp` line per shape, and at the wide widths one `[op]
vit_ln_gemm` line; with --splits only vit_ln_gemm_kernel at every column
split of its forms and passes (`ln_gemm_splits`, `[split]` lines).
`device` is the time of the kernels one call launches
(torch.profiler, mean over REPS calls; tools/bench_attention device_ms;
"not measured" where the traces lost their device events).

Needs a CUDA device: the op launches the hand-written kernels.
"""

from __future__ import annotations

import sys

import torch

from ..ops import kernels as K
from ..ops import plain
from .bench_attention import ATOL, MEAN_TOL, PEAK_BF16_FLOPS, PEAK_BYTES_S, \
    RTOL, device_ms, ms_text, per_call
from .bench_attn_variants import card

EPS = 1e-6
# name, rows, x dtype, output dtype, weights K-major (torch Linear, the
# block's) or MN-major (the JAX layout, fused_ln_mlp's), channels C (the
# hidden is 4 C): ViT-S/14 on vit_mlp_kernel, ViT-B/14 and ViT-L/14 on
# the wide route, each at the eval chunk's query and support passes and
# the training step's frozen trunk
SHAPES = [
    ("block, query pass", 510 * 257, torch.float32, torch.bfloat16, True,
     384),
    ("block, support pass", 34 * 257, torch.float32, torch.bfloat16, True,
     384),
    ("block, training step", 32 * 257, torch.float32, torch.float32, True,
     384),
    ("fused_ln_mlp", 510 * 257, torch.bfloat16, torch.bfloat16, False, 384),
] + [(f"{trunk} block, {where}", rows, torch.float32, odt, True, c)
     for trunk, c in (("ViT-B", 768), ("ViT-L", 1024))
     for where, rows, odt in (("query pass", 510 * 257, torch.bfloat16),
                              ("support pass", 34 * 257, torch.bfloat16),
                              ("training step", 32 * 257, torch.float32))]


def weights(dev, kmajor, seed=0, c=K.VIT_C):
    """vit_mlp's weight dict at c channels (hidden 4 c): bf16 matrices at
    1 / sqrt(fan-in) in either layout, fp32 vectors, LayerScale 1 (every
    step shows in y)."""
    g = torch.Generator().manual_seed(seed)
    f = 4 * c

    def rn(*shape, s=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * s + shift).to(dev)

    w1, w2 = rn(f, c, s=c ** -0.5), rn(c, f, s=f ** -0.5)
    if not kmajor:
        w1, w2 = w1.t(), w2.t()
    return {"g": rn(c, s=0.1, shift=1.0), "be": rn(c, s=0.1),
            "w1": w1.to(torch.bfloat16).contiguous(), "b1": rn(f, s=0.1),
            "w2": w2.to(torch.bfloat16).contiguous(), "b2": rn(c, s=0.1),
            "ls": torch.ones(c, device=dev), "kmajor": kmajor}


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


def event_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms, the host's launch work
    included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(sorted(times)[len(times) // 2])


def bound_ms(n_bytes: float, flops: float):
    """(the least time the card could take, what bounds it): bytes moved
    once over PEAK_BYTES_S against bf16 products over PEAK_BF16_FLOPS."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes > t_ops else "operations"


def ln_gemm_ptxas(b_nk: bool):
    """(registers, spill store bytes, spill load bytes) of the
    vit_ln_gemm_kernel instance a call takes (ptxas's report of this
    process's build), or None where the library was built before it."""
    tag = f"ILb{int(bool(b_nk))}EE"
    for name, regs, st, ld in K.ptxas_usage("vit_ln_gemm_kernel"):
        if tag in name:
            return regs, st, ld
    return None


def ln_gemm_case(name, x, g, be, w, bias, power, *, b_nk=True, gelu=False,
                 round_in=False) -> dict:
    """One `[op] vit_ln_gemm` line: vit_ln_gemm_kernel (ops/kernels.py
    vit_ln_gemm) on x [R, C] against its plain version
    (ops/fused_vit_block.py vit_ln_gemm_plain); its device time, kernels
    a call and CUDA-event ms, TFLOP/s, the share of the bound it reaches
    (x, W, the vectors read once, the bf16 output written once; 2 R C N
    products), the plain version's ms, the plan in use (the card's CTAs,
    column split: ops/kernels.py vit_ln_gemm_card_plan), the instance's
    registers and spills, and, as information, torch.matmul of the same
    product (the bf16 LayerNorm output, made outside the timing, times
    W) and the kernel's ratio to it: no single PyTorch call computes
    LayerNorm + GEMM."""
    from ..ops.fused_vit_block import vit_ln_gemm_plain
    r, c = x.shape
    n = w.shape[0] if b_nk else w.shape[1]
    kw = dict(eps=EPS, b_nk=b_nk, gelu=gelu, round_in=round_in)

    def call():
        return K.vit_ln_gemm(x, g, be, w, bias, **kw)

    def plain_call():
        return vit_ln_gemm_plain(x, g, be, w, bias, **kw)

    out = call()
    torch.cuda.synchronize()
    ref = plain_call()
    d = (out.float() - ref.float()).abs()
    excess = float((d - (ATOL + RTOL * ref.float().abs())).max())
    ok = excess <= 0 and float(d.mean()) <= MEAN_TOL and bool(
        torch.isfinite(out.float()).all())
    del ref
    dev_ms, per, wall, _ = per_call(call)
    ms = event_ms(call)
    plain_ms = event_ms(plain_call, reps=3, warmup=1)
    h = plain.layer_norm(plain.bf16(x) if round_in else x, g, be, EPS).to(
        torch.bfloat16)
    wt = w.t() if b_nk else w
    mm_ms, _, mm_wall = device_ms(lambda: torch.matmul(h, wt))
    del h
    bnd, by = bound_ms(r * c * x.element_size() + 2 * c * n + 2 * r * n
                       + 4 * (2 * c + n), 2.0 * r * c * n)
    plan = K.vit_ln_gemm_card_plan(r, c, n)
    usage = ln_gemm_ptxas(b_nk)
    regs = "not in this process's build" if usage is None else \
        f"{usage[0]} registers, spills {usage[1]} / {usage[2]} B"
    if dev_ms:
        rate = (f"{2.0 * r * c * n / dev_ms / 1e9:.1f} TFLOP/s, "
                f"{bnd / dev_ms * 100:.1f}% of the bound")
    else:
        rate = "TFLOP/s and share of the bound not measured"
    ratio = f"{dev_ms / mm_ms:.2f}x" if dev_ms and mm_ms else "not measured"
    print(f"[op] vit_ln_gemm {name}: rows {r}, C {c}, N {n}, x "
          f"{str(x.dtype).split('.')[-1]}{' rounded' if round_in else ''}, "
          f"{'K' if b_nk else 'MN'}-major W, {'GELU' if gelu else 'no act'}, "
          f"{plan['ctas']} CTAs, "
          f"column split {plan['column_split']} ({plan['units']} units), "
          f"{plan['stages']} slots, {regs}; {ms_text(dev_ms, wall)} in {per} "
          f"kernels, {rate}, kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound "
          f"{bnd:.4f} ms ({by}); torch.matmul of the product alone "
          f"{ms_text(mm_ms, mm_wall)}, the kernel {ratio} of it "
          f"(information); max_abs_err "
          f"{float(d.max()):.4g} mean {float(d.mean()):.3g} (tol {ATOL} + "
          f"{RTOL:.4g}*|ref|, mean {MEAN_TOL}) {'OK' if ok else 'FAIL'} on "
          f"{power}", flush=True)
    return {"name": name, "rows": r, "c": c, "n": n, "device_ms": dev_ms,
            "kernels": per, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "matmul_ms": mm_ms, "max_abs_err": float(d.max()),
            "column_split": plan["column_split"],
            "registers": None if usage is None else usage[0],
            "spills": None if usage is None else usage[1:],
            "ok": ok}


# vit_ln_gemm_kernel's forms at the two trunks: (name, C, N, GELU), and
# the passes whose rows it takes (the eval chunk's query and support
# passes, the training step's frozen trunk)
SPLIT_FORMS = [("qkv, ViT-B", 768, 2304, False), ("fc1, ViT-B", 768, 3072, True),
               ("qkv, ViT-L", 1024, 3072, False),
               ("fc1, ViT-L", 1024, 4096, True)]
SPLIT_PASSES = [("query pass", 510 * 257), ("support pass", 34 * 257),
                ("training step", 32 * 257)]


def ln_gemm_splits(dev, power) -> list:
    """vit_ln_gemm_kernel at every column split 1..groups of each form and
    pass (fp32 x, K-major W): the device ms of each split (torch.profiler,
    device_ms: at the small passes a call's host work outlasts its
    kernel, so CUDA events would time the host), the one the plan
    (ops/kernels.py vit_ln_gemm_card_plan) chooses and the fastest; every
    split's output bit-equal to the whole tiles' (split 1). One `[split]`
    line a form and pass."""
    rows_out = []
    for name, c, n, gelu in SPLIT_FORMS:
        g = torch.Generator().manual_seed(c + n)
        w = (torch.randn(n, c, generator=g) * c ** -0.5).to(dev).to(
            torch.bfloat16)
        gg = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        be = (0.1 * torch.randn(c, generator=g)).to(dev)
        bias = (0.1 * torch.randn(n, generator=g)).to(dev)
        for where, r in SPLIT_PASSES:
            x = torch.randn(r, c, generator=g).to(dev)
            plan = K.vit_ln_gemm_card_plan(r, c, n)

            def call(parts):
                return K.vit_ln_gemm(x, gg, be, w, bias, eps=EPS, gelu=gelu,
                                     round_in=not gelu, column_split=parts)
            whole = call(1)
            times, same = {}, True
            for parts in range(1, plan["groups"] + 1):
                same = same and torch.equal(call(parts), whole)
                times[parts] = device_ms(lambda: call(parts))[0]
            if None in times.values():
                print(f"[split] vit_ln_gemm {name}, {where}: device time not "
                      f"measured (the traces lost their device events)",
                      flush=True)
                continue
            best = min(times, key=times.get)
            chosen = plan["column_split"]
            print(f"[split] vit_ln_gemm {name}, {where}: rows {r}, "
                  f"{plan['tiles']} tiles x {plan['groups']} groups on "
                  f"{plan['ctas']} CTAs; device ms by column split "
                  + ", ".join(f"{k}: {v:.4f}" for k, v in times.items())
                  + f"; the plan's {chosen} ({times[chosen]:.4f} ms, "
                  f"{times[chosen] / times[best]:.3f}x the fastest, {best}); "
                  f"outputs bit-equal across splits: {same} on {power}",
                  flush=True)
            rows_out.append({"name": name, "pass": where, "rows": r,
                             "ms": times, "chosen": chosen, "best": best,
                             "bit_equal": same})
            del x, whole
        torch.cuda.empty_cache()
    return rows_out


def run_case(spec, dev, power):
    name, rows, xdt, odt, kmajor, c = spec
    f = 4 * c
    w = weights(dev, kmajor, c=c)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(rows, c, generator=g).to(dev).to(xdt)
    ref = plain_mlp(x, w).to(odt).float()
    wide = c != K.VIT_C
    if wide:
        def call():
            return K.vit_mlp_wide(x, w, eps=EPS, out_dtype=odt)
    else:
        def call():
            return K.vit_mlp(x, w, eps=EPS, out_dtype=odt)[0]
    y = call()
    torch.cuda.synchronize()
    d = (y.float() - ref).abs()
    excess = float((d - (ATOL + RTOL * ref.abs())).max())
    ok = excess <= 0 and float(d.mean()) <= MEAN_TOL and bool(
        torch.isfinite(y.float()).all())
    del ref, y
    ms, per, wall, _ = per_call(call)
    flops = 2 * rows * 2 * c * f
    n_bytes = rows * c * (x.element_size() + torch.finfo(odt).bits // 8) \
        + 2 * 2 * c * f + 4 * (4 * c + f)
    bnd, by = bound_ms(n_bytes, flops)
    row = {"shape": name, "rows": rows, "c": c, "ms": ms, "kernels": per,
           "bound_ms": bnd, "max_abs_err": float(d.max()), "ok": ok}
    if wide:
        row["chain_ms"] = None
        replaced = ("the wide route: vit_ln_gemm_kernel (LN2, fc1, GELU) and "
                    "the fc2 GEMM + residual; no three-launch chain at this "
                    "width (layernorm_kernel takes up to 512 channels)")
    else:
        chain_ms, chain_k, chain_wall = device_ms(lambda: chain(x, w, odt))
        row["chain_ms"] = chain_ms
        replaced = (f"the chain it replaced (layernorm, fc1 GEMM + GELU, fc2 "
                    f"GEMM + residual) {ms_text(chain_ms, chain_wall)} in "
                    f"{chain_k} kernels")
    print(f"[op] vit_mlp {name}: rows {rows}, C {c}, F {f}, x "
          f"{str(xdt).split('.')[-1]} -> {str(odt).split('.')[-1]}, "
          f"{'K' if kmajor else 'MN'}-major weights, "
          f"{K.vit_mlp_plan(rows, c, f)}: {ms_text(ms, wall)} in {per} "
          f"kernels, "
          f"{'%.1f' % (flops / ms / 1e9) if ms else 'not measured'} "
          f"TFLOP/s, bound {bnd:.4f} ms ({by}); {replaced}; max_abs_err "
          f"{float(d.max()):.4g} mean {float(d.mean()):.3g} (tol {ATOL} + "
          f"{RTOL:.4g}*|ref|, mean {MEAN_TOL}) {'OK' if ok else 'FAIL'} on "
          f"{power}", flush=True)
    if wide:
        row["ln_gemm"] = ln_gemm_case(f"fc1, {name}", x, w["g"], w["be"],
                                      w["w1"], w["b1"], power, b_nk=kmajor,
                                      gelu=True)
        row["ok"] = ok and row["ln_gemm"]["ok"]
    return row


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_vit_mlp needs a CUDA device")
    dev = torch.device("cuda", 0)
    power = card()
    if "--splits" in (sys.argv[1:] if argv is None else argv):
        rows = ln_gemm_splits(dev, power)
        if not all(row["bit_equal"] for row in rows):
            raise SystemExit("vit_ln_gemm's bits depend on its column split")
        return 0
    bad = [spec[0] for spec in SHAPES if not run_case(spec, dev, power)["ok"]]
    if bad:
        raise SystemExit(f"vit_mlp disagrees with plain at: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
