"""The attention kernels at every shape the eval and training paths give
them, on the GPU: kernel against plain, device time, wrapper time, the
card's bound and one PyTorch call (SDPA) on the same shape.

    python -m edgecape_tpu_torch.tools.bench_attention [modes] [bwd]

One line per shape; with `bwd`, only the backward's lines: the training
shapes' gradients (dq, dk, dv, dbias through `flash_mha_train`) against
autograd through the plain version, the backward's device and wrapper time,
its bound and SDPA's backward beside it. `device` is the time of the kernels one call launches
(torch.profiler, mean over REPS calls), so a second kernel (a mask pass)
would show in it and in the kernel count; `wrapper` is the CUDA-event
median around one call of the Python wrapper, which adds the host's share
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

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import flash_attention as FA
from ..ops import kernels as K
from ..ops import plain
from .bench_attn_variants import card

REPS = 10
# |kernel - plain| <= ATOL + RTOL * |plain|, mean within MEAN_TOL: the
# bound chip_smoke.py holds every kernel op to (same bf16 rounding points,
# another summation order).
ATOL, RTOL, MEAN_TOL = 1e-2, 2.0 ** -6, 2e-3
PEAK_BYTES_S, PEAK_BF16_FLOPS = 3.35e12, 989e12

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


def _kernel_durations(fn, reps: int) -> list:
    """(name, duration in us) of each device kernel in a profiler trace of
    `reps` calls of fn. One more call runs first inside the trace and is
    not counted: a trace can lose the device events of its first launches
    (seen with the 30-launch decoder stack), so only kernels that start
    inside the annotated span of the `reps` calls are taken."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
            events = json.load(f)["traceEvents"]
    start = min((float(e["ts"]) for e in events
                 if e.get("name") == "timed calls"
                 and e.get("cat") == "user_annotation"), default=None)
    return [(e["name"], float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"
            and (start is None or float(e["ts"]) >= start)]


def kernel_ms(fn, reps: int = REPS) -> dict:
    """{kernel name: ms of device time per call of fn} from one profiler
    trace of `reps` warm calls (empty when the trace has no device
    events)."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for name, dur in _kernel_durations(fn, reps):
        out[name] = out.get(name, 0.0) + dur / reps / 1e3
    return out


def device_ms(fn, reps: int = REPS):
    """(ms of device time per call of fn, kernels per call): the kernels'
    own durations in a profiler trace of `reps` warm calls. A trace now
    and then comes back without device events, or without some of them
    (a count that is no whole number a call): it is taken again, and
    after three such traces the time is CUDA events around the `reps`
    calls, which holds the host's gaps too (kernels per call: nan)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        durs = [d for _, d in _kernel_durations(fn, reps)]
        if durs and len(durs) % reps == 0:
            return sum(durs) / reps / 1e3, len(durs) / reps
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, float("nan")


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

    def bound_ms(self):
        """Least time for the call: q, k, v, mask and bias (or hops) read
        once, the output (and the training statistics) written once, over
        the memory rate; or its two matrix products over the bf16 rate."""
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (self.q, self.k, self.v, self.valid, self.bias,
                                self.hops) if t is not None)
        out_size = 4 if self.rate is not None else 2
        n_bytes += self.q.numel() * out_size
        if self.rate is not None:
            n_bytes += self.b * self.h * self.nq * 8
        flops = 4.0 * self.b * self.h * self.nq * self.nk * self.d
        t_b, t_o = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def run_case(spec, dev, power, modes=False) -> dict:
    """Checks and times one shape; returns its numbers (ok: within the
    tolerance) and prints its line."""
    case = Case(spec, dev)
    with torch.no_grad():
        out = case.kernel().float()
        ref = case.plain().float().reshape(out.shape)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        excess = (diff - (ATOL + RTOL * ref.abs())).max().item()
        err, mean = diff.max().item(), diff.mean().item()
        ok = excess <= 0 and mean <= MEAN_TOL and bool(
            torch.isfinite(out).all())
        dev_ms, n_kern = device_ms(case.kernel)
        wrap_ms = time_ms(case.kernel)
        sdpa = case.sdpa()
        sdpa_dev_ms, _ = device_ms(sdpa)
        sdpa_ms = time_ms(sdpa)
        bnd, by = case.bound_ms()
        if case.hops is not None:
            plan = K.bias_attention_plan(case.b, case.nq, case.h, case.d)
        else:
            plan = K.attention_plan(case.nq, case.nk, case.d,
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
                alt_ms, _ = device_ms(lambda: case.kernel(plan=alt))
                other += (f" (chunks of {tiles} key tiles, {alt['warps']} "
                          f"warps x {alt['q_split']}: device {alt_ms:.4f} "
                          f"ms)")
    del out, ref, diff
    row = {"name": case.name,
           "shape": [case.b, case.nq, case.nk, case.h, case.d],
           "ok": ok, "max_abs_err": err, "device_ms": dev_ms,
           "kernels_per_call": n_kern, "wrapper_ms": wrap_ms,
           "bound_ms": bnd, "bound_by": by, "sdpa_ms": sdpa_ms,
           "sdpa_device_ms": sdpa_dev_ms, "plan": plan}
    print(f"[op] attention {case.name}: [B {case.b}, Nq {case.nq}, Nk "
          f"{case.nk}, H {case.h}, D {case.d}] max_abs_err {err:.4g} "
          f"mean_abs_err {mean:.3g} (tol {ATOL} + {RTOL:.4g}*|ref|, mean "
          f"{MEAN_TOL}; worst excess {excess:.3g}) device {dev_ms:.4f} ms in "
          f"{n_kern:g} kernel(s) per call, wrapper {wrap_ms:.4f} ms, bound "
          f"{bnd:.4f} ms ({by}), SDPA {sdpa_ms:.4f} ms (device "
          f"{sdpa_dev_ms:.4f} ms), plan {json.dumps(plan)}{other} on {power} "
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
        beforehand and its graph is kept)."""
        gen = torch.Generator(device=self.q.device).manual_seed(5)
        out, leaves = self._graph(FA.flash_mha_train, generator=gen)
        if plan is None:
            return lambda: torch.autograd.grad(out, leaves, self.g,
                                               retain_graph=True)
        _, stats = K.attention_train_fwd(
            self.q, self.k, self.v, num_heads=self.h, scale=self.d ** -0.5,
            key_valid=self.valid, bias=self.bias, rate=0.0)
        g = self.g.reshape(self.b, self.nq, self.h * self.d)
        return lambda: K.attention_train_bwd(
            self.q, self.k, self.v, g, stats, num_heads=self.h,
            scale=self.d ** -0.5, key_valid=self.valid, bias=self.bias,
            rate=0.0, plan=plan)

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

    def bound_ms(self):
        """q, k, v, do, the statistics, mask and bias read once, dq, dk, dv
        and dbias written once, over the memory rate; or the five products
        (s, dp, dq, dk, dv) over the bf16 rate."""
        n_bytes = sum(t.numel() * t.element_size()
                      for t in (self.q, self.k, self.v, self.g, self.valid,
                                self.bias) if t is not None)
        n_bytes += self.b * self.h * self.nq * 8
        n_bytes += 4 * (self.q.numel() + self.k.numel() + self.v.numel())
        if self.bias is not None:
            n_bytes += self.bias.numel() * 4
        flops = 10.0 * self.b * self.h * self.nq * self.nk * self.d
        t_b, t_o = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def run_bwd_case(spec, dev, power, modes=False) -> dict:
    """Checks and times the backward of one training shape; returns its
    numbers and prints its line."""
    case = BwdCase(spec, dev)
    run = case.kernel_backward()
    grads = run()
    ref = case.plain_grads()
    torch.cuda.synchronize()
    err, excess, finite = 0.0, -1.0, True
    for a, r in zip(grads, ref):
        diff = (a.float() - r.float()).abs()
        err = max(err, diff.max().item())
        excess = max(excess, (diff - (ATOL + RTOL * r.float().abs())).max()
                     .item())
        finite = finite and bool(torch.isfinite(a).all())
    again = run()
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    ok = excess <= 0 and finite and same
    dev_ms, n_kern = device_ms(run)
    wrap_ms = time_ms(run)
    sdpa = case.sdpa_backward()
    sdpa_dev_ms, _ = device_ms(sdpa)
    sdpa_ms = time_ms(sdpa)
    bnd, by = case.bound_ms()
    plan, other = K.attention_bwd_plan(case.nq, case.nk, case.d), ""
    if modes and plan["one_pass"]:
        alt = K.attention_bwd_plan(case.nq, case.nk, case.d,
                                   chunk_tiles=K.ATT_CH16)
        alt_ms, _ = device_ms(case.kernel_backward(plan=alt))
        one_ms, _ = device_ms(case.kernel_backward(plan=plan))
        other = (f" (kernels alone at rate 0: one pass {one_ms:.4f} ms, two "
                 f"passes {alt_ms:.4f} ms)")
    row = {"name": case.name + ", backward",
           "shape": [case.b, case.nq, case.nk, case.h, case.d],
           "ok": ok, "max_abs_err": err, "device_ms": dev_ms,
           "kernels_per_call": n_kern, "wrapper_ms": wrap_ms,
           "bound_ms": bnd, "bound_by": by, "sdpa_ms": sdpa_ms,
           "sdpa_device_ms": sdpa_dev_ms, "plan": plan, "bit_equal": same}
    print(f"[op] attention {row['name']}: [B {case.b}, Nq {case.nq}, Nk "
          f"{case.nk}, H {case.h}, D {case.d}] max_abs_err {err:.4g} (tol "
          f"{ATOL} + {RTOL:.4g}*|ref|; worst excess {excess:.3g}; two runs "
          f"bit-equal {same}) device {dev_ms:.4f} ms in {n_kern:g} kernel(s) "
          f"per call, wrapper {wrap_ms:.4f} ms, bound {bnd:.4f} ms ({by}), "
          f"SDPA backward {sdpa_ms:.4f} ms (device {sdpa_dev_ms:.4f} ms), plan "
          f"{json.dumps(plan)}{other} on {power} {'OK' if ok else 'FAIL'}",
          flush=True)
    return row


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if not set(argv) <= {"modes", "bwd"}:
        raise SystemExit("usage: bench_attention [modes] [bwd]")
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention needs a CUDA device")
    dev, power = torch.device("cuda", 0), card()
    modes = "modes" in argv
    rows = []
    for spec in SHAPES:
        if "bwd" not in argv:
            rows.append(run_case(spec, dev, power, modes=modes))
        if spec[-1] is not None:
            rows.append(run_bwd_case(spec, dev, power, modes=modes))
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"attention kernels disagree with plain: {bad}")
    return rows


if __name__ == "__main__":
    main()
