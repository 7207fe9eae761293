"""How far a profiler trace's device timestamps lie from the host's clock,
on the GPU: why tools/bench_attention.py matches kernels to the timed calls
by correlation id and not by where a kernel starts.

    python -m edgecape_tpu_torch.tools.trace_skew [traces]

Traces `traces` times (6 by default) ten calls of the ViT MLP kernel at the
eval chunk's query pass and of the attention kernel at the ViT's eval shape
(one kernel a call each). One `[trace]` line per trace: the kernels in the
trace (bench_attention.PRIMER + 1 of them open it, then one warm call and
the ten timed calls: fewer means lost device events), those matched to
the ten calls by correlation id (span_work), those
a filter by the kernel's start would keep (starts inside the calls' span),
and the least lead of a kernel's start over its own launch on the host
(negative: the kernel appears to start before it was launched, so the
device's clock, converted, lies at least that far behind the host's).

Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from . import bench_attention as BA
from . import bench_vit_mlp as BM
from .bench_attn_variants import card

REPS = 10


def skew(events: list) -> dict:
    """kernels / matched / by_start / least_lead_us of one trace's events
    (see the module docstring); matched is None when the trace lacks the
    span or a launched kernel's event."""
    span = [e for e in events if e.get("name") == "timed calls"
            and e.get("cat") == "user_annotation"]
    t0 = float(span[0]["ts"]) if span else None
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in BA.HOST_CALLS
              and "Launch" in e.get("name", "")
              and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    leads = [float(e["ts"]) - launch[e["args"]["correlation"]]
             for e in kernels
             if e.get("args", {}).get("correlation") in launch]
    work = BA.span_work(events)
    return {"kernels": len(kernels),
            "matched": None if work is None else sum(
                cat == "kernel" for _, _, cat in work),
            "by_start": None if t0 is None else sum(
                float(e["ts"]) >= t0 for e in kernels),
            "least_lead_us": min(leads) if leads else None}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("trace_skew needs a CUDA device")
    traces = int(argv[0]) if argv else 6
    dev = torch.device("cuda", 0)
    power = card()
    w = BM.weights(dev, True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(BM.SHAPES[0][1], BA.K.VIT_C, generator=g).to(dev)
    case = BA.Case(BA.SHAPES[0], dev)
    fns = {"vit_mlp": lambda: BA.K.vit_mlp(x, w, eps=BM.EPS,
                                           out_dtype=torch.bfloat16),
           "attention": case.kernel}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for i in range(traces):
        for name, fn in fns.items():
            r = skew(BA.trace_events(fn, REPS))
            print(f"[trace] {name} {i}: {r['kernels']} kernels in the trace, "
                  f"{r['matched']} matched to the {REPS} calls by "
                  f"correlation id, {r['by_start']} starting inside their "
                  f"span; least lead of a kernel over its launch "
                  f"{r['least_lead_us']:.1f} us on {power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
