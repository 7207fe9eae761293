"""Probe: does cutting the matmul chain's row tiles from a group's folded
rows (M = g * n) beat cutting them inside each image (M = n)? The
counterpart of scripts/probe_m_fold.py.

On the TPU the question was the matrix unit's fill and drain at M = n
against M = g * n. On the GPU it is tile quantisation: `ops.mm_chain`
works on tiles of 64 rows, and n = 264 leaves every image a tile with 8
valid rows of 64 (n = 104 one with 40), which the folded rows of a group
avoid. Both cuts do the same useful operations and must give the same
bits; the tool compares the whole [b, n, c] output.

For each of the three cases of the JAX script (the backbone's MLP shape at
the eval chunk with groups of 2 and 4, the decoder's keypoint-token shape
with groups of 6) it prints one line: loop ms, fold ms, TFLOP/s of each
(flops = 2 * 2 * b * n * c * f * reps), the ratio and `bitsame`. Times are
CUDA events around ITERS launches, best of RUNS.

    python -m edgecape_tpu_torch.tools.probe_m_fold
    python -m edgecape_tpu_torch.tools.probe_m_fold --device cpu \\
        --case 4,2,8,16,32,2        # b,g,n,c,f,reps: the plain version

Runs on the CUDA device and raises without one; `--device cpu` times the
plain version on the host clock at the size the caller gives.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.mm_chain import mm_chain

ITERS, RUNS = 20, 3

# (label, b, g, n, c, f, reps): backbone MLP shape at the eval chunk;
# decoder keypoint-token shape (n = 104 is the worst tile fill)
CASES = [
    ("backbone n=264 c=384 f=1536 g=2", 512, 2, 264, 384, 1536, 6),
    ("backbone n=264 g=4", 512, 4, 264, 384, 1536, 6),
    ("decoder  n=104 c=256 f=1024 g=6", 510, 6, 104, 256, 1024, 6),
]


def inputs(b, n, c, f, device):
    """The JAX script's operands: seeded normal x, weights scaled by 0.05."""
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
    w1 = torch.from_numpy((rng.normal(size=(c, f)) * 0.05).astype(np.float32))
    w2 = torch.from_numpy((rng.normal(size=(f, c)) * 0.05).astype(np.float32))
    return x.to(bf).to(device), w1.to(bf).to(device), w2.to(bf).to(device)


def run(b, g, n, c, f, reps, fold, device="cuda", iters=ITERS, runs=RUNS):
    """(best seconds per call, flops, output) of one variant."""
    x, w1, w2 = inputs(b, n, c, f, device)
    on_card = torch.device(device).type == "cuda"
    out = mm_chain(x, w1, w2, reps, g, fold)
    best = float("inf")
    for _ in range(runs):
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(iters):
                mm_chain(x, w1, w2, reps, g, fold)
            e1.record()
            torch.cuda.synchronize()
            best = min(best, e0.elapsed_time(e1) * 1e-3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                mm_chain(x, w1, w2, reps, g, fold)
            best = min(best, (time.perf_counter() - t0) / iters)
    flops = 2 * 2 * b * n * c * f * reps
    return best, flops, out


def probe(label, b, g, n, c, f, reps, device="cuda", iters=ITERS,
          runs=RUNS) -> dict:
    t_loop, flops, o_loop = run(b, g, n, c, f, reps, False, device, iters,
                                runs)
    t_fold, _, o_fold = run(b, g, n, c, f, reps, True, device, iters, runs)
    return {"label": label, "loop_ms": t_loop * 1e3, "fold_ms": t_fold * 1e3,
            "loop_tflops": flops / t_loop / 1e12,
            "fold_tflops": flops / t_fold / 1e12,
            "speedup": t_loop / t_fold,
            "bitsame": bool(torch.equal(o_loop, o_fold)),
            "finite": bool(torch.isfinite(o_fold.float()).all())}


def _case(text: str):
    vals = [int(v) for v in text.split(",")]
    if len(vals) != 6:
        raise argparse.ArgumentTypeError("a case is b,g,n,c,f,reps")
    b, g, n, c, f, reps = vals
    return (f"b={b} g={g} n={n} c={c} f={f} reps={reps}", *vals)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--case", type=_case, action="append",
                    help="b,g,n,c,f,reps in place of the three built-in "
                         "cases (may be repeated)")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--runs", type=int, default=RUNS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("probe_m_fold needs a CUDA device (pass "
                               "--device cpu for the plain version)")
        print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    elif not args.case:
        raise SystemExit("--device cpu needs a --case b,g,n,c,f,reps of a "
                         "size the host can take")
    else:
        print("device=cpu (plain version, host clock)", flush=True)
    results = []
    for case in args.case or CASES:
        r = probe(*case, device=args.device, iters=args.iters, runs=args.runs)
        results.append(r)
        print(f"{r['label']:36s} loop {r['loop_ms']:7.2f} ms "
              f"({r['loop_tflops']:5.1f} TF/s)  "
              f"fold {r['fold_ms']:7.2f} ms "
              f"({r['fold_tflops']:5.1f} TF/s)  "
              f"speedup {r['speedup']:.3f}x  bitsame={r['bitsame']}",
              flush=True)
    return results


if __name__ == "__main__":
    main()
