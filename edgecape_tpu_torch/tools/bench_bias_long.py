"""Device time of the bias attention above 128 keypoints (ops/kernels.py
bias_attention: bias_attn_long_kernel), for holding two checkouts of the port
against each other on the card, in turns (parent, change, change, parent):

    python edgecape_tpu_torch/tools/bench_bias_long.py [--root DIR]
        [--label NAME] [--shapes B,K,H,D ...] [--build-only]

--root imports the package of another checkout (the parent's, unpacked from
`git archive`, or a copy with an edited kernel source) with this script, as
tools/reference_outputs.py does. Each shape: seeded operands made on the card
(5 hop planes, 12 hidden units, about 30% of the keys masked), one warm call,
then REPS calls captured in a CUDA graph and the graph replayed TIMES times;
`ms` is the median CUDA-event time of a replay over REPS (the kernels' own
time and the graph's gaps between launches), `launches` the wrapper's count
of one call by kernel, `bits` a hash of the output's bf16 bits (two
checkouts that agree there computed the same bits). One JSON line a shape,
with the card's name and power limit. --build-only builds the kernels and
prints ptxas's registers and spills of bias_attn_long_kernel. Needs a CUDA
device."""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

REPS, TIMES = 10, 5
NHOP, HID = 5, 12
# [B, K, H, D]: the eval chunk's 510 rows and the [widths] chunk's 60 at
# COCO-WholeBody's 133 keypoints, Halpe's 136, whole 64-key tiles (256) and
# a ragged tile (300), at the stage-3 heads (8 of 32) and at 512 channels
SHAPES = [(b, k, 8, d) for d in (32, 64) for k in (133, 256, 300)
          for b in (60, 510)] + [(510, 136, 8, 32), (510, 132, 8, 32)]


def card_power() -> str:
    """`name, power limit` of the card as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def operands(dev, b, k, h, d, seed):
    """qkv bf16 [B, K, 3 H D], key mask [B, K], hops bf16 [B, K, K, NHOP],
    the MLP (w1 [NHOP, HID], b1, w2 [HID, H], b2), made on the card from a
    seed."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    c = h * d
    qkv = torch.randn(b, k, 3 * c, generator=g, device=dev).to(torch.bfloat16)
    valid = torch.rand(b, k, generator=g, device=dev) > 0.3
    valid[:, 0] = True
    hops = torch.rand(b, k, k, NHOP, generator=g, device=dev).to(
        torch.bfloat16)
    mlp = (torch.randn(NHOP, HID, generator=g, device=dev),
           torch.randn(HID, generator=g, device=dev) * 0.1,
           torch.randn(HID, h, generator=g, device=dev) * HID ** -0.5,
           torch.randn(h, generator=g, device=dev) * 0.1)
    return qkv, valid, hops, mlp


def graph_ms(fn, reps: int = REPS, times: int = TIMES) -> float:
    """Median CUDA-event time of a CUDA graph of `reps` calls of fn, over
    `reps`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(times):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        z.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(z) / reps)
    del graph
    return sorted(out)[len(out) // 2]


def run(shapes, label: str) -> list:
    import torch
    from edgecape_tpu_torch.ops import kernels as K
    dev = torch.device("cuda", 0)
    power = card_power()
    rows = []
    for i, (b, k, h, d) in enumerate(shapes):
        qkv, valid, hops, mlp = operands(dev, b, k, h, d, seed=1000 + i)

        def call():
            return K.bias_attention(qkv, valid, hops, mlp, num_heads=h)
        before = dict(K.launches)
        out = call()
        torch.cuda.synchronize()
        launches = {n: v - before.get(n, 0) for n, v in K.launches.items()
                    if v != before.get(n, 0)}
        bits = hashlib.sha1(out.view(torch.int16).cpu().numpy().tobytes())
        row = {"label": label, "shape": [b, k, k, h, d],
               "plan": K.bias_attention_plan(b, k, h, d),
               "ms": graph_ms(call), "launches": launches,
               "bits": bits.hexdigest()[:16], "card": power}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del qkv, valid, hops, mlp, out
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    p.add_argument("--label", default="tree")
    p.add_argument("--shapes", nargs="*", metavar="B,K,H,D")
    p.add_argument("--build-only", action="store_true")
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_bias_long needs a CUDA device")
    from edgecape_tpu_torch.ops import kernels as K
    if args.build_only:
        K.build()
        for fn, regs, st, ld in K.ptxas_usage("bias_attn_long_kernel"):
            print(f"[{args.label}] ptxas {fn}: {regs} registers, spill "
                  f"stores {st} B, loads {ld} B", flush=True)
        return
    shapes = SHAPES if not args.shapes else [
        tuple(int(v) for v in s.split(",")) for s in args.shapes]
    run(shapes, args.label)


if __name__ == "__main__":
    main()
