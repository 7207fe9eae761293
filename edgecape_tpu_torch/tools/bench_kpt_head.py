"""The keypoint head at head widths other than 256 channels
(csrc/kpt_wide.cu kpt_head_wide_kernel, ops/kernels.py kpt_head),
measured three ways:

* times: the device ms of one launch (profiler; tools/bench_attention
  device_ms) at each width and row count, beside its bound (the two
  passes' products of the true width / 989 TFLOP/s) and the share of it;
* clocks: where a tile's time goes, in SM clocks: a copy of the kernel's
  source with clock64() stores after each phase (the tile's rows in, the
  final norm, each layer's first pass and whole layer, the coordinates
  out; the first consumer thread of each warpgroup, the first three
  tiles of every block), built alone into the build directory and run in
  the library's place; the median over blocks of each mark after the
  tile's start;
* errors: the coordinates against ops/fused_decoder.py kpt_head_plain with
  its products summed in fp32 and in float64 (the kernel's, and on the
  CPU two models of its accumulator: 16-deep steps each rounded toward
  zero over the whole depth, as one wgmma accumulator sums, and the
  kernel's 64-deep slabs of such steps added in fp32 round to nearest),
  each the max and mean over both passes' coordinates.

    python -m edgecape_tpu_torch.tools.bench_kpt_head [times] [clocks] [errors]

The operands are those of tests/test_torch_cuda.py's keypoint head tests
(kpt_branch at 1 / sqrt(C), the delta head at 0.02, x ~ N(0, 1)), drawn
from a seeded generator on the CPU. Times and clocks need a CUDA device;
errors use one where there is one (the models always run on the CPU).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops import fused_decoder as FD
from ..ops import kernels as K
from ..ops import plain
from .bench_attention import PEAK_BF16_FLOPS, device_ms, ms_text
from .bench_attn_variants import card

# widths (the [widths] ones but 256, the odd one the card tests take) and
# the row counts of 60 and 510 query rows of K 100
TIME_CASES = [(c, r) for c in (128, 200, 384, 512) for r in (6000, 51000)]
CLOCK_CASES = [(200, 6000), (200, 51000), (512, 6000), (512, 51000)]
ERROR_CASES = [(200, 6000), (384, 6000), (511, 6000), (512, 6000)]
# the clock marks: after these lines of csrc/kpt_wide.cu (mark, line)
MARKS = (
    (1, "    sync();                          "
        "// the tile's A rows are in the boxes\n"),
    (2, "        kw_pass<KS, PQ, S>(sum, tmp, ring, xa, lane);\n"),
    (3, "        sync();                      "
        "// h is whole in the next boxes\n      }\n"),
)
MARK_NAMES = {1: "rows in and final norm", 2: "layer 0's first pass",
              3: "layer 0", 4: "layer 1's first pass", 5: "layer 1",
              6: "layer 2's first pass", 7: "layer 2", 9: "coordinates out"}


def operands(c, r, seed, dev):
    """x, ct, the final norm, the kpt_branch layers unpadded and padded to
    the plan's c_pad, the delta head."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)
    cp = K.kpt_head_plan(r, c)["c_pad"]
    kpt0 = [(rn(c, c, s=c ** -0.5).to(torch.bfloat16), rn(c, s=0.1))
            for _ in range(3)]
    kpt = [(K.pad_cols(w, cp, cp).contiguous(), b) for w, b in kpt0]
    fn = (1.0 + rn(c, s=0.1), rn(c, s=0.1))
    kow, kob = rn(2, c, s=0.02).to(torch.bfloat16), rn(2, s=0.02)
    x = rn(r, c).to(torch.bfloat16)
    ct = torch.rand(r, 2, generator=g).to(dev)
    ct[0] = torch.tensor([0.0, 1.0])
    return x, ct, fn, kpt0, kpt, kow, kob


def run_kernel(ops):
    x, ct, fn, _, kpt, kow, kob = ops
    pts, outs = torch.empty_like(ct), torch.empty_like(ct)
    K.kpt_head(x, ct, fn, kpt, kow, kob, pts, outs, eps=1e-5)
    return torch.stack([pts, outs])


def times(dev, power):
    for c, r in TIME_CASES:
        ops = operands(c, r, 1, dev)
        dev_ms, _, wall = device_ms(lambda: run_kernel(ops))
        bnd = 2 * 2 * r * (3 * c * c + 2 * c) / PEAK_BF16_FLOPS * 1e3
        share = "" if dev_ms is None else \
            f", {100 * bnd / dev_ms:.1f}% of it"
        print(f"[kpt] times C {c}, {r} rows: {ms_text(dev_ms, wall)}, bound "
              f"{bnd:.4f} ms (operations){share}; plan "
              f"{K.kpt_head_plan(r, c)} on {power}", flush=True)


def _instrumented(src: str) -> str:
    """kpt_wide.cu with clock64() marks and an entry that reads them."""
    head = '#include "dec_wide.cuh"\n'
    add = (head
           + "__device__ unsigned long long kw_clock[132 * 2 * 3 * 16];\n"
           "#define KW_MARK(e) do { if (ct == 0 && tile_n < 3 && "
           "blockIdx.x < 132) kw_clock[((blockIdx.x * 2 + wg) * 3 + tile_n) "
           "* 16 + (e)] = clock64(); } while (0)\n"
           'extern "C" int kw_clock_read(void* host, int clear) {\n'
           "  static unsigned long long zero[132 * 2 * 3 * 16];\n"
           "  return clear ? (int)cudaMemcpyToSymbol(kw_clock, zero, "
           "sizeof(zero))\n"
           "               : (int)cudaMemcpyFromSymbol(host, kw_clock, "
           "sizeof(kw_clock));\n"
           "}\n")
    wait = "    cp_async_wait<0>();\n    sync();"
    edits = [(head, add),
             ("  unsigned n = 0;\n", "  unsigned n = 0;\n  int tile_n = -1;\n"),
             (wait, "    ++tile_n;\n    KW_MARK(0);\n" + wait)]
    marks = {1: "    KW_MARK(1);\n",
             2: "        if (q == 0) KW_MARK(2 + 2 * l);\n",
             3: "      KW_MARK(3 + 2 * l);\n"}
    edits += [(line, line + marks[m]) for m, line in MARKS]
    end = re.search(r"\n(          dst\[2 \* r \+ o\] = .*\n"
                    r"        \}\n      \}\n    \}\n)", src)
    if end is None:
        raise SystemExit("bench_kpt_head: csrc/kpt_wide.cu no longer has the "
                         "marked lines")
    edits.append((end.group(1), end.group(1) + "    KW_MARK(9);\n"))
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit("bench_kpt_head: csrc/kpt_wide.cu no longer has "
                             f"the marked line {old.strip()!r}")
        src = src.replace(old, new)
    return src


def clocks(dev, power):
    """The instrumented copy, built alone and run in the library's place."""
    K.lib()
    src = _instrumented(open(os.path.join(K.CSRC, "kpt_wide.cu")).read())
    os.makedirs(K.build_dir(), exist_ok=True)
    path = os.path.join(K.build_dir(), "kpt_wide_clocks.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    subprocess.run([K._nvcc()] + K.NVCC_FLAGS
                   + ["-I", K.CSRC, "-o", so, path], check=True)
    copy = ctypes.CDLL(so)
    copy.ec_kpt_head_wide.argtypes = K._SIGNATURES["ec_kpt_head_wide"]
    copy.ec_kpt_head_wide.restype = ctypes.c_int
    copy.kw_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib = K._LIB

    class Lib:
        def __getattr__(self, name):
            return getattr(copy if name == "ec_kpt_head_wide" else lib, name)
    buf = (ctypes.c_ulonglong * (132 * 2 * 3 * 16))()
    K._LIB = Lib()
    try:
        for c, r in CLOCK_CASES:
            ops = operands(c, r, 1, dev)
            for _ in range(3):
                run_kernel(ops)
            torch.cuda.synchronize()
            copy.kw_clock_read(None, 1)
            run_kernel(ops)
            torch.cuda.synchronize()
            copy.kw_clock_read(ctypes.addressof(buf), 0)
            a = np.array(buf, dtype=np.int64).reshape(132, 2, 3, 16)
            for tn in (0, 1):
                for wg in (0, 1):
                    t = a[:, wg, tn]
                    t = t[t[:, 0] > 0]
                    if not len(t):
                        continue
                    marks = [f"{name} {np.median(t[:, e] - t[:, 0]):.0f}"
                             for e, name in MARK_NAMES.items()]
                    print(f"[kpt] clocks C {c}, {r} rows, tile {tn}, "
                          f"warpgroup {wg} ({len(t)} blocks), from the "
                          f"tile's start: " + "; ".join(marks)
                          + f" on {power}", flush=True)
    finally:
        K._LIB = lib


def _model(ops, slab):
    """The coordinates with the products summed as wgmma does: 16-deep
    steps into an fp32 accumulator, each step's sum rounded toward zero,
    over `slab`-deep runs that fp32 then adds round to nearest (slab None:
    one accumulator over the whole depth)."""
    x, ct, fn, kpt0, _, kow, kob = (t if not torch.is_tensor(t) else t.cpu()
                                    for t in ops)
    fn = tuple(v.cpu() for v in fn)
    kpt0 = [(w.cpu(), b.cpu()) for w, b in kpt0]

    def steps(h, w, k0, k1):
        acc = torch.zeros(h.shape[0], w.shape[0], dtype=torch.float32)
        for k in range(k0, k1, 16):
            s = acc.double() + h[:, k:k + 16] @ w[:, k:k + 16].t()
            f = s.float()
            over = f.double().abs() > s.abs()
            acc = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
        return acc

    r = x.shape[0]
    kh = torch.cat([x.float(), plain.layer_norm(x, *fn, 1e-5)])
    for w, b in kpt0:
        hb, wb = plain.bf16(kh).double(), plain.bf16(w).double()
        depth = hb.shape[1]
        run = slab or depth
        y = torch.zeros(hb.shape[0], wb.shape[0], dtype=torch.float32)
        for k0 in range(0, depth, run):
            y = y + steps(hb, wb, k0, min(k0 + run, depth))
        kh = plain.gelu(y + b.float())
    dd = plain.linear(kh, kow, kob)
    inv = FD.inverse_sigmoid(ct.float())
    return torch.stack([torch.sigmoid(inv + dd[:r]),
                        torch.sigmoid(inv + dd[r:])])


def errors(dev, power):
    torch.set_num_threads(max(os.cpu_count() or 1, 1))
    for c, r in ERROR_CASES:
        ops = operands(c, r, c + r, dev)
        x, ct, fn, kpt0, _, kow, kob = ops
        ref = torch.stack(FD.kpt_head_plain(x, ct, fn, kpt0, kow, kob,
                                            eps=1e-5, sums=torch.float64))
        ref32 = torch.stack(FD.kpt_head_plain(x, ct, fn, kpt0, kow, kob,
                                              eps=1e-5))
        rows = {"fp32 plain": ref32}
        if dev.type == "cuda":
            rows["kernel"] = run_kernel(ops)
        rows["model, one accumulator"] = _model(ops, None).to(dev)
        rows["model, 64-deep slabs"] = _model(ops, 64).to(dev)
        text = "; ".join(
            f"{name} max {(v - ref).abs().max().item():.4g} mean "
            f"{(v - ref).abs().mean().item():.3g}" for name, v in rows.items())
        print(f"[kpt] errors C {c}, {r} rows, against the float64-summed "
              f"plain version: {text} on {power}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv or ["times", "clocks", "errors"]
    bad = [w for w in which if w not in ("times", "clocks", "errors")]
    if bad:
        raise SystemExit(f"bench_kpt_head: unknown mode(s) {bad}")
    cuda = torch.cuda.is_available()
    if not cuda and which != ["errors"]:
        raise SystemExit("bench_kpt_head: times and clocks need a CUDA device")
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    power = card() if cuda else "the CPU (no kernel)"
    for w in which:
        {"times": times, "clocks": clocks, "errors": errors}[w](dev, power)
    return 0


if __name__ == "__main__":
    sys.exit(main())
