"""The attention kernels at every shape the eval and training paths give
them, on the GPU: kernel against plain, device time, wrapper time, the
card's bound and one PyTorch call (SDPA) on the same shape; with `long`,
also the plain version's time and each kernel's own device time.

    python -m edgecape_tpu_torch.tools.bench_attention [modes] [bwd] [long]

One line per shape; with `long`, the streaming kernels' shapes
(LONG_SHAPES: the 518 px path's rows, just past the caps, a ragged
count, head dim 128 past its resident kernel's 416 keys); with `bwd`,
only the backward's lines: the training shapes' gradients (dq, dk, dv,
dbias through `flash_mha_train`) against autograd through the plain
version, the backward's device and wrapper time,
its bound and SDPA's backward beside it. `device` is the time of the
kernels one call launches (torch.profiler, mean over REPS calls, the
kernels matched to the calls by correlation id), so a second kernel (a
mask pass) would show in it and in the kernel count; where no trace has
whole device events the line says "device not measured" beside the
CUDA-event wall time, and the count comes from the wrappers' launch
counters; `wrapper` is the CUDA-event median around one call of the
Python wrapper, which adds the host's share
when the device is faster than the host can launch. SDPA gets pre-transposed
bf16 operands and a ready additive mask, and is used by nothing in the
package. With `modes`, the shapes whose key row fits in registers are
also timed with the two-pass plan (chunks of 32 keys), which is how the
plan's choice was made.

Needs a CUDA device: the ops launch the hand-written kernels.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import flash_attention as FA
from ..ops import kernels as K
from ..ops import plain
from .bench_attn_variants import card

REPS = 10
TRACE_TRIES = 6     # traces taken before device events are given up
PRIMER = 16         # kernels that open a trace, before the calls it times
# |kernel - plain| <= ATOL + RTOL * |plain|, mean within MEAN_TOL: the
# bound chip_smoke.py holds every kernel op to (same bf16 rounding points,
# another summation order).
ATOL, RTOL, MEAN_TOL = 1e-2, 2.0 ** -6, 2e-3
PEAK_BYTES_S, PEAK_BF16_FLOPS = 3.35e12, 989e12
# Base-2 exponentials a second on the special-function units: 132 SMs x 16
# a clock (NVIDIA's CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) at SM_CLOCK_HZ, the SM clock at
# which the tensor cores give PEAK_BF16_FLOPS (989e12 / (132 x 4096)).
SM_CLOCK_HZ = 1.83e9
PEAK_EX2_S = 132 * 16 * SM_CLOCK_HZ


def floors_ms(n_bytes: float, flops: float, exps: float) -> dict:
    """The three floors of an attention call in ms: its bytes over the
    memory rate, its tensor-core operations over the bf16 rate, its
    exponentials (one a score) over the special-function units' rate."""
    return {"bytes": n_bytes / PEAK_BYTES_S * 1e3,
            "tensor": flops / PEAK_BF16_FLOPS * 1e3,
            "exp": exps / PEAK_EX2_S * 1e3}


def bound_of(floors: dict):
    """(bound ms, "bytes" or "operations"): the largest of the floors; the
    tensor cores' and the exponentials' are both operations."""
    t = max(floors.values())
    return t, "bytes" if floors["bytes"] >= t else "operations"

# name, batch, queries, keys, heads, head dim, key mask, bias ("read": an
# fp32 [B, H, Nq, Nk] tensor, "hops": formed from the bf16 hop stack by the
# decoder stack's bias attention, ops/kernels.py bias_attention), training
# dropout rate (None: the eval kernel)
SHAPES = [
    ("vit eval", 510, 257, 257, 6, 64, False, None, None),
    ("vit training", 32, 257, 257, 6, 64, False, None, None),
    ("joint encoder", 510, 356, 356, 8, 32, True, None, None),
    ("decoder self, bias read", 510, 100, 100, 8, 32, True, "read", None),
    ("decoder self, bias from hops", 510, 100, 100, 8, 32, True, "hops",
     None),
    ("decoder cross", 510, 100, 256, 8, 64, False, None, None),
    ("skeleton refine (flash_mha)", 34, 100, 100, 8, 32, True, None, None),
    ("train encoder, rate 0", 16, 356, 356, 8, 32, True, None, 0.0),
    ("train encoder, rate 0.1", 16, 356, 356, 8, 32, True, None, 0.1),
    ("train skeleton, rate 0.1", 16, 100, 100, 8, 32, True, None, 0.1),
    ("train decoder, bias, rate 0", 16, 100, 100, 8, 32, True, "read", 0.0),
    ("train decoder, bias, rate 0.1", 16, 100, 100, 8, 32, True, "read",
     0.1),
]
N_HOP, HOP_HID = 5, 12            # the model's: max_hops + 1, max_hops + 8
# The streaming kernels (csrc/attn_long.cu): the 518 px path's rows (ViT
# 1370 tokens, joint encoder 1369 + 100 keys, decoder cross-attention 100 x
# 1369; the training encoder) at batches whose plain version (fp32
# [B, H, Nq, Nk] scores) fits the card, rows just past the caps (513 keys;
# the ViT at 273 and 325 tokens, which its own kernel no longer holds) and
# a ragged count. The last field: the plan is forced long (the ViT's
# route streams its keys past 272 tokens, where attention_plan would pick
# the resident two-pass form).
LONG_SHAPES = [
    (("vit 518 px", 16, 1370, 1370, 6, 64, False, None, None), False),
    (("joint encoder 518 px", 16, 1469, 1469, 8, 32, True, None, None),
     False),
    (("decoder cross 518 px", 64, 100, 1369, 8, 64, False, None, None),
     False),
    (("past 512 keys", 16, 513, 513, 8, 32, True, None, None), False),
    (("vit 273 tokens", 64, 273, 273, 6, 64, False, None, None), True),
    (("vit 325 tokens", 64, 325, 325, 6, 64, False, None, None), True),
    (("ragged 1025", 8, 1025, 1025, 8, 32, True, None, None), False),
    (("train encoder 518 px, rate 0", 8, 1469, 1469, 8, 32, True, None,
      0.0), False),
    (("train encoder 518 px, rate 0.1", 8, 1469, 1469, 8, 32, True, None,
      0.1), False),
    (("train past 512, bias, rate 0", 4, 513, 513, 8, 32, True, "read",
      0.0), False),
    # head dim 128 past the resident kernel's 416 keys: the decoder's
    # cross-attention of the 512 / 8 head at 518 px (the [long] chunk's 60
    # rows and the eval chunk's 510; the 384 / 8 head's head dim 96 runs
    # padded to it), a direct flash_mha_train call at the joint encoder's
    # length, and attn_long_kernel<128> forced at the 224 px cross shape
    # that attn_kernel<128> holds (times only: that route stays resident)
    (("decoder cross 518 px, 8 x 128", 60, 100, 1369, 8, 128, False, None,
      None), False),
    (("decoder cross 518 px, 8 x 128, 510 rows", 510, 100, 1369, 8, 128,
      False, None, None), False),
    (("train 518 px, 4 x 128, rate 0", 8, 1469, 1469, 4, 128, True, None,
      0.0), False),
    (("train 518 px, 4 x 128, rate 0.1", 8, 1469, 1469, 4, 128, True, None,
      0.1), False),
    (("decoder cross 224 px, 8 x 128, forced", 60, 100, 256, 8, 128, False,
      None, None), True),
]

# The head dims the kernels run padded (ops/kernels.py pad_heads: 25 at 32,
# 50 at 64) or at their own head dim 128, at the shapes of the heads of
# 200 channels in 8 heads (self-attention 25, cross-attention 50; FFN 300)
# and of 512 in 8 (64 and 128), a cached eval chunk of 4 x 15 queries and
# a training step of 8 rows at 224 px, K 100: every instance of the eval
# and the training kernels at head dim 128 (one pass and two, the training
# pair's direct call), and bias_attn_wide_kernel (8 heads of 25 and of 64,
# also at the eval chunk's 510 rows).
WIDTH_SHAPES = [
    ("encoder, head dim 25", 60, 356, 356, 8, 25, True, None, None),
    ("decoder self, head dim 25, bias from hops", 60, 100, 100, 8, 25, True,
     "hops", None),
    ("decoder self, head dim 25, bias from hops, 510 rows", 510, 100, 100, 8,
     25, True, "hops", None),
    ("decoder cross, head dim 50", 60, 100, 256, 8, 50, False, None, None),
    ("decoder self, head dim 64, bias from hops", 60, 100, 100, 8, 64, True,
     "hops", None),
    ("decoder self, head dim 64, bias from hops, 510 rows", 510, 100, 100, 8,
     64, True, "hops", None),
    ("decoder cross, head dim 128", 60, 100, 256, 8, 128, False, None, None),
    ("keypoints, head dim 128", 60, 100, 100, 4, 128, True, None, None),
    ("train encoder, head dim 25, rate 0.1", 8, 356, 356, 8, 25, True, None,
     0.1),
    ("train decoder, head dim 25, bias, rate 0.1", 8, 100, 100, 8, 25, True,
     "read", 0.1),
    ("train encoder, head dim 128, rate 0.1", 8, 356, 356, 4, 128, True,
     None, 0.1),
    ("train keypoints, head dim 128, rate 0", 8, 100, 100, 4, 128, True,
     None, 0.0),
]


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms."""
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
    return float(np.median(times))


# what a trace shows of the device's work, and the host's calls that start it
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALLS = ("cuda_runtime", "cuda_driver")


def span_work(events: list):
    """(name, duration in us, category) of the device work (kernels and
    copies) started inside the "timed calls" span of a profiler trace's
    events, or None when the trace lacks the span or the device event of
    a kernel launched inside it. Work is matched to the host's runtime
    calls by their correlation id, and a call belongs to the span by its
    host timestamp: the device's timestamps, converted to the host's
    clock, were seen to lie milliseconds off (tools/trace_skew.py), so
    where a kernel starts says nothing of which call launched it."""
    span = [e for e in events if e.get("name") == "timed calls"
            and e.get("cat") == "user_annotation"]
    if not span:
        return None
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])

    def corr(e):
        return e.get("args", {}).get("correlation")

    calls = {corr(e): e["name"] for e in events
             if e.get("cat") in HOST_CALLS and corr(e) is not None
             and t0 <= float(e["ts"]) <= t1}
    work = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_WORK and corr(e) in calls]
    seen = {corr(e) for e in work}
    if any("Launch" in name and c not in seen for c, name in calls.items()):
        return None
    return [(e["name"], float(e["dur"]), e["cat"]) for e in work]


def trace_events(fn, reps: int) -> list:
    """The events of a profiler trace (chrome trace format) of `reps`
    calls of fn inside a "timed calls" span. Before the span the trace
    holds PRIMER one-element adds and one more call of fn: a trace was
    seen to lack the device events of its first two or three kernels
    (the warm call's and the first timed calls'), and those kernels take
    that loss."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad = torch.zeros(1, device="cuda")
        for _ in range(PRIMER):
            pad.add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        with record_function("timed calls"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def traced(fn, reps: int = 1):
    """span_work of a trace of fn (trace_events), taken again (after a
    synchronize and a short pause) up to TRACE_TRIES times while a trace
    lacks a kernel's device event or its kernel count is no positive whole
    number a call; None when no trace had them."""
    for attempt in range(TRACE_TRIES):
        if attempt:
            torch.cuda.synchronize()
            time.sleep(0.2)
        events = trace_events(fn, reps)
        work = span_work(events)
        n = sum(cat == "kernel" for _, _, cat in work or ())
        if n and n % reps == 0:
            return work
    print(f"[trace] no whole trace of {reps} calls in {TRACE_TRIES}; the "
          f"last: {trace_summary(events)}", file=sys.stderr, flush=True)
    return None


def trace_summary(events: list) -> str:
    """What a trace holds, to tell why span_work refused it: the span, the
    runtime calls inside it (launches and others, by name), how many of
    the launches have their kernel, and the kernels in the whole trace
    with their correlation ids."""
    span = [e for e in events if e.get("name") == "timed calls"
            and e.get("cat") == "user_annotation"]
    if not span:
        return "no span"
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])

    def corr(e):
        return e.get("args", {}).get("correlation")

    calls = [e for e in events if e.get("cat") in HOST_CALLS
             and t0 <= float(e["ts"]) <= t1]
    kernels = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel"]
    have = {corr(e) for e in kernels}
    names = {}
    for e in calls:
        names[e["name"]] = names.get(e["name"], 0) + 1
    launches = [corr(e) for e in calls if "Launch" in e["name"]]
    return (f"span {t1 - t0:.1f} us, runtime calls {names}, launches "
            f"{launches}, {sum(c in have for c in launches)} with their "
            f"kernel; {len(kernels)} kernels in the trace, correlation "
            f"{sorted(c for c in have if c is not None)}")


def kernel_ms(fn, reps: int = REPS) -> dict:
    """{kernel name: ms of device time per call of fn} from a profiler
    trace of `reps` warm calls (empty when no trace had whole device
    events)."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for name, dur, cat in traced(fn, reps) or ():
        if cat == "kernel":
            out[name] = out.get(name, 0.0) + dur / reps / 1e3
    return out


def device_ms(fn, reps: int = REPS):
    """(device ms per call, kernels per call, wall ms per call) of fn: the
    kernels' own durations in a profiler trace of `reps` warm calls
    (`traced`), as (device ms, kernels, None); when no trace had whole
    device events, (None, None, the CUDA-event time of `reps` calls,
    host gaps included): never a wall time in the device time's place."""
    fn()
    torch.cuda.synchronize()
    work = traced(fn, reps)
    if work is not None:
        durs = [d for _, d, cat in work if cat == "kernel"]
        return sum(durs) / reps / 1e3, len(durs) // reps, None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return None, None, a.elapsed_time(b) / reps


def launched(fn) -> dict:
    """{kernel name: launches} of one call of fn, from the wrappers' exact
    counters (ops/kernels.py launch_counts); PyTorch's own kernels are not
    counted."""
    before = K.launch_counts()
    fn()
    after = K.launch_counts()
    return {k: n - before[k] for k, n in after.items() if n != before[k]}


# a count from the wrappers' counters sees no kernel of PyTorch's own
COUNTERS = "launch counters (PyTorch's own kernels unchecked)"


def per_call(fn, reps: int = REPS):
    """device_ms with the kernel count taken from the launch counters
    when the traces lost their events: (device ms or None, kernels per
    call or None, wall ms or None, where the count came from: "trace",
    COUNTERS or None)."""
    dev, n, wall = device_ms(fn, reps)
    if n is not None and math.isfinite(n) and n == int(n):
        return dev, int(n), wall, "trace"
    n = sum(launched(fn).values()) or None
    return None, n, wall, None if n is None else COUNTERS


def plain_text(ms) -> str:
    """The plain version's time where it was taken."""
    return "" if ms is None else f"plain {ms:.4f} ms, "


def floors_text(floors: dict) -> str:
    return (f"floors: bytes {floors['bytes']:.4f}, tensor "
            f"{floors['tensor']:.4f}, exp {floors['exp']:.4f} ms at "
            f"{SM_CLOCK_HZ / 1e9:.2f} GHz")


def ms_text(dev, wall) -> str:
    """A device time, or that it was not measured (and the wall time)."""
    if dev is not None:
        return f"device {dev:.4f} ms"
    return "device not measured" + (
        "" if wall is None else f"; wall {wall:.4f} ms (CUDA events)")


class Case:
    """Seeded operands of one shape: q, k, v as strided views of one fused
    bf16 projection (separate ones for cross-attention), as the fused ops
    hand them to the kernel."""

    def __init__(self, spec, dev, seed=0):
        (self.name, b, nq, nk, h, d, mask, bias, self.rate) = spec
        self.b, self.nq, self.nk, self.h, self.d = b, nq, nk, h, d
        g = torch.Generator().manual_seed(seed)
        c = h * d
        dt = torch.float32 if self.rate is not None else torch.bfloat16

        def rn(*shape):
            return torch.randn(*shape, generator=g).to(dev)

        if nq == nk:
            self.qkv = rn(b, nq, 3 * c).to(dt)
            self.q, self.k, self.v = (self.qkv[..., i * c:(i + 1) * c]
                                      for i in range(3))
        else:
            self.q = rn(b, nq, c).to(dt)
            kv = rn(b, nk, 2 * c).to(dt)
            self.k, self.v = kv[..., :c], kv[..., c:]
        self.valid = None
        if mask:
            self.valid = (torch.rand(b, nk, generator=g) > 0.25).to(dev)
            self.valid[:, 0] = True
        self.bias = self.hops = self.hop_mlp = None
        if bias == "read":
            self.bias = rn(b, h, nq, nk)
        elif bias == "hops":
            self.hops = (torch.rand(b, nq, nk, N_HOP, generator=g) / 4).to(
                dev).to(torch.bfloat16)
            self.hop_mlp = (rn(N_HOP, HOP_HID), rn(HOP_HID) * 0.1,
                            rn(HOP_HID, h) / math.sqrt(HOP_HID), rn(h) * 0.1)

    def heads(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.h, self.d)

    def plain_bias(self):
        if self.hops is None:
            return self.bias
        w1, b1, w2, b2 = self.hop_mlp
        hid = torch.relu(self.hops.float() @ w1 + b1)
        return (hid @ w2 + b2).permute(0, 3, 1, 2)

    def kernel(self, plan=None):
        if self.rate is not None and plan is not None:
            seed = None
            if self.rate > 0:
                gen = torch.Generator(device=self.q.device).manual_seed(5)
                seed = FA.dropout_seed(gen, self.q.device)
            return K.attention_train_fwd(
                self.q, self.k, self.v, num_heads=self.h,
                scale=self.d ** -0.5, key_valid=self.valid, bias=self.bias,
                seed=seed, rate=self.rate, plan=plan)[0]
        if self.rate is not None:
            gen = torch.Generator(device=self.q.device).manual_seed(5)
            return FA.flash_mha_train(
                self.heads(self.q), self.heads(self.k), self.heads(self.v),
                self.valid, self.bias, dropout_rate=self.rate, generator=gen)
        if self.hops is not None:
            return K.bias_attention(self.qkv, self.valid, self.hops,
                                    self.hop_mlp, num_heads=self.h)
        return K.attention(self.q, self.k, self.v, num_heads=self.h,
                           scale=self.d ** -0.5, key_valid=self.valid,
                           bias=self.bias, plan=plan)

    def plain(self):
        if self.rate is not None:
            keep = None
            if self.rate > 0:
                gen = torch.Generator(device=self.q.device).manual_seed(5)
                seed = FA.dropout_seed(gen, self.q.device)
                keep = K.dropout_mask(seed, self.rate, self.b * self.h,
                                      self.nq, self.nk).reshape(
                    self.b, self.h, self.nq, self.nk)
            return FA.flash_mha_train_plain(
                self.heads(self.q), self.heads(self.k), self.heads(self.v),
                self.valid, self.bias, dropout_rate=self.rate, keep=keep)
        kb = None if self.valid is None else plain.key_bias(self.valid)
        return plain.attention(self.q, self.k, self.v, num_heads=self.h,
                               scale=self.d ** -0.5, kb=kb,
                               bias=self.plain_bias())

    def sdpa(self):
        """The library call on the same shape: [B, H, N, D] bf16 operands
        and, where the shape has a mask or a bias, one additive bf16 mask
        made beforehand."""
        bf = torch.bfloat16
        q, k, v = (self.heads(t).transpose(1, 2).to(bf).contiguous()
                   for t in (self.q, self.k, self.v))
        mask = None
        if self.valid is not None:
            mask = plain.key_bias(self.valid)[:, None, None, :]
        bias = self.plain_bias()
        if bias is not None:
            mask = bias if mask is None else mask + bias
        if mask is not None:
            mask = mask.to(bf)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def floors_ms(self) -> dict:
        """The call's floors (floors_ms): q, k, v, mask and bias (or hops)
        read once, the output (and the training statistics) written once;
        its two matrix products; one exponential a score."""
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (self.q, self.k, self.v, self.valid, self.bias,
                                self.hops) if t is not None)
        out_size = 4 if self.rate is not None else 2
        n_bytes += self.q.numel() * out_size
        if self.rate is not None:
            n_bytes += self.b * self.h * self.nq * 8
        scores = float(self.b * self.h * self.nq * self.nk)
        return floors_ms(n_bytes, 4.0 * scores * self.d, scores)

    def bound_ms(self):
        """Least time for the call: the largest of its floors."""
        return bound_of(self.floors_ms())


def run_case(spec, dev, power, modes=False, long=False,
             full=False) -> dict:
    """Checks and times one shape; returns its numbers (ok: within the
    tolerance) and prints its line. long: the plan forced to the
    streaming kernels; full: also the plain version's time and each
    kernel's device time (`by_kernel`), else None and {}."""
    case = Case(spec, dev)
    forced = None
    if long:
        forced = K.attention_plan(case.nq, case.nk, case.d,
                                  train=case.rate is not None, long=True)
    kernel = case.kernel if forced is None else (
        lambda: case.kernel(plan=forced))
    with torch.no_grad():
        out = kernel().float()
        ref = case.plain().float().reshape(out.shape)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        excess = (diff - (ATOL + RTOL * ref.abs())).max().item()
        err, mean = diff.max().item(), diff.mean().item()
        ok = excess <= 0 and mean <= MEAN_TOL and bool(
            torch.isfinite(out).all())
        dev_ms, n_kern, wall_ms, count_from = per_call(kernel)
        wrap_ms = time_ms(kernel)
        plain_ms = time_ms(case.plain, reps=3, warmup=1) if full else None
        sdpa = case.sdpa()
        sdpa_dev_ms, _, sdpa_wall = device_ms(sdpa)
        sdpa_ms = time_ms(sdpa)
        bnd, by = case.bound_ms()
        floors = case.floors_ms()
        if case.hops is not None:
            plan = K.bias_attention_plan(case.b, case.nq, case.h, case.d)
        else:
            plan = forced or K.attention_plan(case.nq, case.nk, case.d,
                                              train=case.rate is not None)
        other = ""
        if modes and case.hops is None:
            for tiles in (K.ATT_ROW16, K.ATT_CH16):
                if tiles == plan["chunk_tiles"] or (
                        tiles == K.ATT_ROW16 and case.nk > 128):
                    continue
                alt = K.attention_plan(case.nq, case.nk, case.d,
                                       train=case.rate is not None,
                                       chunk_tiles=tiles)
                alt_ms, _, alt_wall = device_ms(
                    lambda: case.kernel(plan=alt))
                other += (f" (chunks of {tiles} key tiles, {alt['warps']} "
                          f"warps x {alt['q_split']}: "
                          f"{ms_text(alt_ms, alt_wall)})")
    del out, ref, diff
    row = {"name": case.name,
           "shape": [case.b, case.nq, case.nk, case.h, case.d],
           "ok": ok, "max_abs_err": err, "device_ms": dev_ms,
           "wall_ms": wall_ms, "kernels_per_call": n_kern,
           "count_from": count_from, "wrapper_ms": wrap_ms,
           "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
           "floors_ms": floors, "sdpa_ms": sdpa_ms,
           "sdpa_device_ms": sdpa_dev_ms, "plan": plan,
           "by_kernel": kernel_ms(kernel) if full else {}}
    print(f"[op] attention {case.name}: [B {case.b}, Nq {case.nq}, Nk "
          f"{case.nk}, H {case.h}, D {case.d}] max_abs_err {err:.4g} "
          f"mean_abs_err {mean:.3g} (tol {ATOL} + {RTOL:.4g}*|ref|, mean "
          f"{MEAN_TOL}; worst excess {excess:.3g}) {ms_text(dev_ms, wall_ms)}"
          f" in {n_kern} kernel(s) per call (by {count_from}), wrapper "
          f"{wrap_ms:.4f} ms, {plain_text(plain_ms)}bound {bnd:.4f} ms "
          f"({by}; {floors_text(floors)}), SDPA {sdpa_ms:.4f} "
          f"ms ({ms_text(sdpa_dev_ms, sdpa_wall)}), plan "
          f"{json.dumps(plan)}{other} on {power} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return row


class BwdCase(Case):
    """A training shape's backward: the gradients of
    sum(flash_mha_train(q, k, v, mask, bias) * g) through the kernels,
    through the plain version and through SDPA."""

    def __init__(self, spec, dev, seed=0):
        super().__init__(spec, dev, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        self.g = torch.randn(self.b, self.nq, self.h, self.d,
                             generator=gen).to(dev)

    def _leaves(self):
        ts = [self.heads(t).detach().clone().requires_grad_(True)
              for t in (self.q, self.k, self.v)]
        if self.bias is not None:
            ts.append(self.bias.detach().clone().requires_grad_(True))
        return ts

    def _graph(self, fn, **kw):
        leaves = self._leaves()
        bias = leaves[3] if self.bias is not None else None
        out = fn(*leaves[:3], self.valid, bias, dropout_rate=self.rate, **kw)
        return out, leaves

    def kernel_backward(self, plan=None):
        """A function that runs the backward kernels once (the forward ran
        beforehand and its graph is kept) and returns the gradients of
        q, k, v (and the bias). `plan`: the backward's plan, the kernels
        called directly after a forward with the matching plan (the
        streaming one where `plan` streams)."""
        gen = torch.Generator(device=self.q.device).manual_seed(5)
        if plan is None:
            out, leaves = self._graph(FA.flash_mha_train, generator=gen)
            return lambda: torch.autograd.grad(out, leaves, self.g,
                                               retain_graph=True)
        seed = FA.dropout_seed(gen, self.q.device) if self.rate > 0 else None
        kw = dict(num_heads=self.h, scale=self.d ** -0.5,
                  key_valid=self.valid, bias=self.bias, seed=seed,
                  rate=self.rate)
        fplan = K.attention_plan(self.nq, self.nk, self.d, train=True,
                                 long=bool(plan.get("long")))
        out, stats = K.attention_train_fwd(self.q, self.k, self.v,
                                           plan=fplan, **kw)
        g = self.g.reshape(self.b, self.nq, self.h * self.d)

        def run():
            grads = K.attention_train_bwd(self.q, self.k, self.v, g, stats,
                                          plan=plan, out=out, **kw)
            leaves = [self.heads(t) for t in (self.q, self.k, self.v)]
            return [t.reshape(leaf.shape) for t, leaf in
                    zip(grads, leaves + [self.bias]) if t is not None]
        return run

    def plain_grads(self):
        keep = None
        if self.rate > 0:
            gen = torch.Generator(device=self.q.device).manual_seed(5)
            seed = FA.dropout_seed(gen, self.q.device)
            keep = K.dropout_mask(seed, self.rate, self.b * self.h, self.nq,
                                  self.nk).reshape(self.b, self.h, self.nq,
                                                   self.nk)
        out, leaves = self._graph(FA.flash_mha_train_plain, keep=keep)
        return torch.autograd.grad(out, leaves, self.g)

    def sdpa_backward(self):
        """SDPA's backward on the same shape: bf16 [B, H, N, D] leaves and
        a ready additive mask that takes no gradient."""
        bf = torch.bfloat16
        q, k, v = (self.heads(t).transpose(1, 2).to(bf).contiguous()
                   .requires_grad_(True) for t in (self.q, self.k, self.v))
        mask = plain.key_bias(self.valid)[:, None, None, :]
        if self.bias is not None:
            mask = mask + self.bias
        mask = mask.to(bf).expand(self.b, self.h, self.nq, self.nk)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        g = self.g.transpose(1, 2).to(bf).contiguous()
        return lambda: torch.autograd.grad(out, (q, k, v), g,
                                           retain_graph=True)

    def bound_ms(self, part=None):
        """Least time for the backward: q, k, v, do, the statistics, mask
        and bias read once, dq, dk, dv and dbias written once, over the
        memory rate; the five products (s, dp, dq, dk, dv) over the bf16
        rate; or one exponential a score (p recomputed) over the
        special-function units' rate. part "q": the query-major kernel's
        function alone (the same reads; dq, delta and dbias written; s, dp
        and dq), "k": the key-major kernel's (the same reads and delta; dk
        and dv written; s, dp, dk and dv); each recomputes p."""
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (self.q, self.k, self.v, self.g, self.valid,
                                self.bias) if t is not None)
        n_bytes += self.b * self.h * self.nq * 8
        delta = self.b * self.h * self.nq * 4
        dbias = 0 if self.bias is None else self.bias.numel() * 4
        products = {None: 5, "q": 3, "k": 4}[part]
        n_bytes += {None: 4 * (self.q.numel() + self.k.numel()
                               + self.v.numel()) + dbias,
                    "q": 4 * self.q.numel() + delta + dbias,
                    "k": delta + 4 * (self.k.numel() + self.v.numel())}[part]
        scores = float(self.b * self.h * self.nq * self.nk)
        return bound_of(floors_ms(n_bytes, 2.0 * products * scores * self.d,
                                  scores))


def run_bwd_case(spec, dev, power, modes=False, full=False,
                 long=False) -> dict:
    """Checks and times the backward of one training shape; returns its
    numbers and prints its line: every gradient within ATOL + RTOL |plain|
    and MEAN_TOL on the mean, finite, and the same bits from two calls.
    full: also the plain version's time, each kernel's device time
    (`by_kernel`), each gradient's worst difference (`errs`) and each
    kernel's own bound (`part_bounds`). long: the streaming pair forced
    (called directly, after the streaming forward)."""
    case = BwdCase(spec, dev)
    forced = K.attention_bwd_plan(case.nq, case.nk, case.d, long=True) \
        if long else None
    run = case.kernel_backward(plan=forced)
    grads = run()
    ref = case.plain_grads()
    torch.cuda.synchronize()
    errs, means, excess, finite = {}, {}, -1.0, True
    for name, a, r in zip(("dq", "dk", "dv", "dbias"), grads, ref):
        diff = (a.float() - r.float()).abs()
        errs[name] = diff.max().item()
        means[name] = diff.mean().item()
        excess = max(excess, (diff - (ATOL + RTOL * r.float().abs())).max()
                     .item())
        finite = finite and bool(torch.isfinite(a).all())
    err = max(errs.values())
    again = run()
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    ok = excess <= 0 and max(means.values()) <= MEAN_TOL and finite and same
    dev_ms, n_kern, wall_ms, count_from = per_call(run)
    wrap_ms = time_ms(run)
    plain_ms = (time_ms(case.plain_grads, reps=3, warmup=1) if full
                else None)
    sdpa = case.sdpa_backward()
    sdpa_dev_ms, _, sdpa_wall = device_ms(sdpa)
    sdpa_ms = time_ms(sdpa)
    bnd, by = case.bound_ms()
    plan, other = forced or K.attention_bwd_plan(case.nq, case.nk,
                                                 case.d), ""
    if modes and plan["one_pass"] and not plan.get("long"):
        alt = K.attention_bwd_plan(case.nq, case.nk, case.d,
                                   chunk_tiles=K.ATT_CH16)
        two_t = device_ms(case.kernel_backward(plan=alt))
        one_t = device_ms(case.kernel_backward(plan=plan))
        other = (f" (kernels alone: one pass "
                 f"{ms_text(one_t[0], one_t[2])}, two passes "
                 f"{ms_text(two_t[0], two_t[2])})")
    row = {"name": case.name + ", backward",
           "shape": [case.b, case.nq, case.nk, case.h, case.d],
           "ok": ok, "max_abs_err": err, "device_ms": dev_ms,
           "wall_ms": wall_ms, "kernels_per_call": n_kern,
           "count_from": count_from, "wrapper_ms": wrap_ms,
           "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
           "sdpa_ms": sdpa_ms, "sdpa_device_ms": sdpa_dev_ms, "plan": plan,
           "bit_equal": same, "mean_abs_err": max(means.values())}
    if full:
        row.update(by_kernel=kernel_ms(run), errs=errs,
                   part_bounds={p: case.bound_ms(p) for p in ("q", "k")})
    print(f"[op] attention {row['name']}: [B {case.b}, Nq {case.nq}, Nk "
          f"{case.nk}, H {case.h}, D {case.d}] max_abs_err {err:.4g} (tol "
          f"{ATOL} + {RTOL:.4g}*|ref|; worst excess {excess:.3g}; mean "
          f"{max(means.values()):.3g}, tol {MEAN_TOL}; two runs "
          f"bit-equal {same}) {ms_text(dev_ms, wall_ms)} in {n_kern} "
          f"kernel(s) per call (by {count_from}), wrapper {wrap_ms:.4f} ms, "
          f"{plain_text(plain_ms)}bound {bnd:.4f} ms ({by}), SDPA "
          f"backward {sdpa_ms:.4f} ms "
          f"({ms_text(sdpa_dev_ms, sdpa_wall)}), plan {json.dumps(plan)}"
          f"{other} on {power} {'OK' if ok else 'FAIL'}",
          flush=True)
    return row


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if not set(argv) <= {"modes", "bwd", "long"}:
        raise SystemExit("usage: bench_attention [modes] [bwd] [long]")
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention needs a CUDA device")
    dev, power = torch.device("cuda", 0), card()
    modes, full = "modes" in argv, "long" in argv
    shapes = LONG_SHAPES if full else [(s, False) for s in SHAPES]
    rows = []
    for spec, forced in shapes:
        if "bwd" not in argv:
            rows.append(run_case(spec, dev, power, modes=modes, long=forced,
                                 full=full))
        if spec[-1] is not None:
            rows.append(run_bwd_case(spec, dev, power, modes=modes,
                                     full=full))
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"attention kernels disagree with plain: {bad}")
    return rows


if __name__ == "__main__":
    main()
