"""Chip smoke test of the PyTorch + CUDA port (edgecape_tpu_torch) on one
NVIDIA GPU. Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
1. device and build: prints the card's name and power limit, the torch
   and CUDA versions, builds the hand-written kernels (nvcc, sm_90a) and
   prints the build time;
2. each kernel op against its plain PyTorch version on the card, at the
   main path's shapes, with seeded inputs, LayerScale 1 and non-zero
   biases; prints the max error beside the tolerance and both times
   (CUDA events, median of several runs), the least time the card could
   take for the same work (bytes moved once over 3.35 TB/s, or the
   operations over 989 TFLOP/s bf16, whichever is larger) and, where one
   PyTorch call computes the same function, that call's time.
   fused_vit_block is also held at the training step's shape (support
   and query images of one batch together). The training attention
   (flash_mha_train) is checked at its three call-site shapes: forward and dq, dk, dv, dbias at rate 0 against autograd
   through the plain version; at rate 0.1 against the plain version fed
   the kernels' own keep mask; the mask's keep share; same seed, same
   output; another seed, another mask. Then the two attention forward
   kernels at every shape the paths give them (ViT, joint encoder,
   decoder self- and cross-attention, skeleton refine, the training
   sites with and without dropout), one `[op] attention` line each from
   tools/bench_attention.py: kernel against plain within the same
   tolerance, device time (profiler), wrapper time, bound, SDPA on the
   same shape with the mask it needs, and the launch plan used; the
   training shapes also get a backward line (gradients against autograd
   through the plain version, two runs bit-equal, the two backward kernels'
   device time and nothing else launched, wrapper time, bound, SDPA's
   backward). Then the GEMM behind the fused ops at the paths' shapes, one
   `[op] gemm` line each from tools/bench_gemm.py: the TMA + wgmma
   mainloop and the thread-copy one against a float64 reference, their
   times, TFLOP/s, bound, torch.matmul, and which mainloop the dispatch
   takes. Every [op] line of a fused op counts its GEMMs by mainloop;
   the ViT block's, the encoder stack's and the decoder layer's lines add
   their device time, kernels per call (at most 3, 10 and 8; the ViT
   block's are vit_qkv_kernel, vit_attn_kernel and vit_mlp_kernel, no
   GEMM) and ms by kernel (where the traces lose their device events, the
   count comes from the wrappers' launch counters and the time reads "not
   measured"; an op with no count fails), and the encoder's
   library time is that of nn.TransformerEncoderLayer;
3. the main path: a stage-3 PoseEstimator (learned skeleton + Markov
   bias, K=100, 224 px, 1 shot, bf16 compute and head dtype, full
   ViT-S/14 width and depth, weights drawn from a seed with the
   zero-initialised parts redrawn) runs the port's depth-2 cached eval
   loop over 3 chunks of 34 episode groups x 15 queries built in memory;
   predictions are decoded on the host and scored (PCK); the launch
   counters must show every kernel op ran as often as the path implies,
   every GEMM of it the TMA + wgmma mainloop, each layer of the
   encoder and the decoder its post-attention kernels once and each ViT
   block vit_qkv_kernel and vit_attn_kernel (its attention half) and
   vit_mlp_kernel (its MLP half) once;
   one chunk is compared with the same weights on the plain (no kernel)
   path on the card; one more chunk of the kernel path runs under
   torch.profiler, which gives device time by kernel and the device's
   busy share of that chunk's wall time. Then a head of d_model 128 in 4
   heads over a two-block ViT-S/14, asked for on the card with the
   kernels on, must be refused when it is built, naming the ops whose
   kernels do not take 128 channels, with no kernel launched
   (`[widths]`);
4. the training path: the port's Trainer (stage 3: learned skeleton,
   Markov bias, masked supervision, skeleton frozen; full ViT-S/14,
   K=100, 224 px, 64x64 heatmaps, batch 16, dropout 0.1, fp32 head over
   the bf16 fused backbone) warm-started from a checkpoint of seeded
   weights, fit for 6 steps on one re-fed in-memory batch, then a stage-2
   trainer for 2 steps with its eval hook on a small in-memory validation
   set. It fails unless the losses are finite, the
   forward / backward launch counters of flash_mha_train equal what the
   path implies, frozen parameters are bit-unchanged and trainable ones
   moved, the re-fed batch's loss without dropout fell, and one step's
   gradients on the kernel path agree with the plain path
   (use_flash=False). Prints ms/step of both paths and profiles one warm
   step;
5. the kernel-variant ops against their plain versions at the eval
   chunk's shapes: fused_ln_mlp (one vit_mlp_kernel launch, no GEMM) and
   fused_attn_block (vit_qkv_kernel then vit_attn_kernel, no GEMM) at
   [510, 257, 384], each with device time, kernels per call and ms by
   kernel; vit_mlp_kernel at every shape the paths give it against the
   three launches it replaced (tools/bench_vit_mlp.py), and vit_qkv_kernel
   and vit_attn_kernel, each against its plain version, beside the four
   launches they replaced and SDPA with a torch.matmul projection
   (tools/bench_vit_attn.py); fused_vit_block2 bit-equal to two
   fused_vit_block calls (bf16 and fp32 input), each of its blocks
   against the plain block, six kernels a call;
   the decoder stack's own kernels, the bias attention and the keypoint
   head, each against its plain version at 510 rows, K=100;
   fused_decoder_stack (510 rows, K=100, 256 image tokens, C=256, 3
   layers, Markov bias) layer by layer on the same inputs, then the whole
   stack against the chain of fused_decoder_layer with the glue in
   PyTorch; its line adds device time, kernels per call (at most 30, none
   of them a thread-copy GEMM) and ms by kernel;
6. the variant path: forward_cached at full width with the decoder_stack
   and vit_pair_blocks switches on (launch counts per chunk asserted,
   predictions against the default path), the throughput of the default
   path, both switches and each switch alone in turns, and the A/B ratio
   of each switch (`--write-tuned PATH` writes them as a measured-defaults
   file);
7. the uncached path: run_eval(cache_supports=False) over in-memory
   episodes at full width, 1-shot and 5-shot, through the kernels, held
   against the cached loop on the same episodes; forward_debug on one
   batch; the strict fp32 estimator on the card (TF32 switched on around
   it, which it must switch off) against the same estimator on the CPU;
8. the bench tool's four chains (tools/bench_attn_variants.py) at full
   width, which launch fused_attn_block and fused_ln_mlp;
9. the matmul chain of the probe tool (ops/mm_chain.py) against its
   plain version at a small shape and at the tool's three cases, row tiles
   cut per image (`loop`) and per group (`fold`), the two bit-equal over
   the whole output, each with its share of the bound and of useful rows
   in its tiles, beside a chain of 2 x reps cuBLAS calls (a yardstick the
   port never calls) and ptxas's registers and spills of the kernel; then
   the tool itself
   (python -m edgecape_tpu_torch.tools.probe_m_fold), its three lines;
10. the disk path: the port's generator writes a synthetic MP-100 stand-in
   (PPM images, COCO json) to a temporary directory; the full-width
   stage-3 model trains through `cli.train` (main with an argv) for two
   short epochs of batch 16 with the threaded loader, then `cli.test`
   evaluates the checkpoint that wrote, cached and with
   --no-cache-supports. Launch counters of both runs, the files they must
   leave (result_keypoints.json, testing_log.txt, train_log.jsonl,
   config.json, a TensorBoard event file read back), finite metrics, the
   same PCK from both eval loops; prints the disk eval's img/s beside its
   host collate, dispatch and device-wait seconds, and ms per training
   step with the loader;
11. the serving path (`[serve]`, edgecape_tpu_torch/cli/serve.py): first
   the kernel ops it and the demo launch, at their shapes and fp32 in and
   out, against their plain versions (`[op]` lines: flash_mha on the fp32
   ViT at 224 px and 256 px and on one group's keypoints;
   fused_encoder_stack and fused_decoder_stack at 1 and 16 rows); then
   the port's PoseService (stage-3 model, 224 px, K=100, fp32, seeded
   weights, the variant switches of the measured-defaults file) behind a
   ThreadingHTTPServer on 127.0.0.1 in this process: a 1-shot and a
   5-shot /support, 20 sequential /predict (p50, p95 ms), 16 concurrent
   /predict on one context (fewer dispatches than requests), 64 from 8
   threads (requests/s, mean batch fill), a /predict_batch of 16 and
   /healthz; the answers against a service on the strict path
   (use_flash=False) with the same weights on the same requests, the
   batch and the coalesced answers against the single ones, the launch
   counters of every kernel op of the path above 0 (and none on the
   strict path); /reload of a checkpoint of other seeded head weights
   (contexts dropped, answers equal to a service built with them); one
   bucket-16 dispatch under the profiler;
12. the router (`[router]`, cli/router.py): two services on the card, each
   behind its own HTTP server, behind the port's router: sticky
   /predict, a rolling /reload, one replica's server shut down (503
   "context lost" for its contexts) and rejoining once it is up again;
13. the demo (`[demo]`, cli/demo.py infer) at its default 256 px on a
   support / query pair with an annotation dict: launch counters, the
   predictions against the strict path, the figure where matplotlib
   imports; the same model in bf16 at 256 px refused when it is built
   (the fused ViT block does not hold 325 tokens);
14. multi-process training and eval (`[dist]`, parallel/, eval/runner.py
   and train/loop.py in a process group): prints
   torch.cuda.device_count(), then
   two ranks (subprocesses of this script, a file:// rendezvous) of the
   full-width stage-3 model share the card through gloo: each takes 2
   Trainer steps (dropout 0, kernels on) of its 8 rows of a global batch
   of 16, then a cached run_eval of its 2 of 4 episode groups x 15
   queries, gathered. Gates: the reduced gradient of step 1 and its loss
   dict against one process's step on the 16 rows (in this process), the
   parameters after step 2 bit-equal across ranks, the gathered records
   and metrics against one process's eval; the same kernel-path
   gradients and records against one process on the plain path
   (use_flash=False: no kernel in the head) on the same weights, rows and
   chunks, with the plain path's own 16-rows-vs-8+8 gap printed beside
   the kernel path's, and which of the shared trunk's stages gives an
   image other bits in a call on 32 images than on 16; and each rank's
   launch counters (#1, #7, #8 in training; #1, #3, #6, #4 in eval). With two
   cards or more the same runs with NCCL, a card a rank; with one card
   it says "NCCL not measured". The ranks' step ms are information only
   (they share one card: no scaling figure);
15. the eval chunk's stages (`[stages]`,
   tools/profile_eval_stages.py at its full case): device ms of the
   backbone, support and query phases, the head, the query encoder, the
   encoder and decoder kernels alone and the whole chunk; support +
   query beside the chunk; the chunk's eager aten::addmm by call site;
16. prints {"kernels": [...]} on its own line, then the result line
   {"ok": true, "device": {...}} last. The kernels line holds, besides
   each kernel op's entry, the serving shapes' entries (`flash_mha (ViT
   fp32, 224 px)` and the rest); an op's `launches` is its count on the
   main path (phase 3), its `serve_launches`, `router_launches` and
   `demo_launches` those on phases 11-13, `dist_launches` rank 0's on
   phase 14 (gloo), and a serving shape's `launches` its op's count on
   the path of that shape.
Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

import glob
import json
import math
import os
import subprocess
import sys
import time
import tempfile
import types

import numpy as np
import torch
import torch.nn.functional as F

GROUPS, QUERIES, CHUNKS, K, SIZE = 34, 15, 3, 100, 224
SEED = 0

# |kernel - plain| <= ATOL + RTOL * |plain|: both follow the same bf16
# rounding points; summation order differs, which can move a bf16 value
# by an ulp (2^-8 relative) and carry it through the rest of the op.
ATOL, RTOL, MEAN_TOL = 1e-2, 2.0 ** -6, 2e-3
# The encoder stack is checked layer by layer, each layer against the
# plain layer on the kernel's own input: a one-ulp difference in one
# layer is amplified by the next (the same stack on the CPU with fp64
# instead of fp32 accumulation differs by up to 0.034, mean 0.0034, after
# its third layer), which says nothing about the kernels.
# Main path against the plain (no kernel) path on the card: both bf16
# with different rounding points, and the local 3x3 soft-argmax can move
# a keypoint by a whole 1/16 feature cell on a near tie; so the bound is
# on the median and on the share of coordinates within one cell.
PATH_MEDIAN_TOL, PATH_CELL, PATH_WITHIN_SHARE = 0.01, 1.0 / 16, 0.9
# flash_mha_train against its plain version (randn inputs, so gradients
# are typically 0.1-0.2 in size): the output keeps the bound above; dq,
# dk, dv get a tighter absolute part, dbias (fp32 on both sides, no
# rounding of its own) an absolute bound alone, and every tensor a bound
# on its relative L2 error (measured 5e-5 at most), which a scaling fault
# of a percent or a missing rounding point exceeds.
GRAD_ATOL, DBIAS_ATOL, TENSOR_REL_L2 = 5e-3, 1e-4, 1e-3

# The card's published peaks (H100 SXM): device memory rate, dense bf16
# tensor-core rate, fp32 rate outside the tensor cores. bound_ms of a
# kernel is the larger of its bytes (each input read once, each output
# written once) over the first and its operations over the peak rate of
# their type.
PEAK_BYTES_S, PEAK_BF16_FLOPS, PEAK_F32_FLOPS = 3.35e12, 989e12, 67e12
# fused_decoder_stack: one layer on the same inputs, kernel against plain,
# on coordinates in [0, 1] (the delta heads are drawn with weights of
# 0.02, so one bf16 ulp of a token moves a coordinate by about 1e-5 and a
# handful of them add up); the whole stack against the layer chain within
# the JAX package's bounds for that pair, and not bit-equal.
STACK_LAYER_MAX, STACK_LAYER_MEAN = 2e-3, 1e-4
STACK_CHAIN_MEDIAN, STACK_CHAIN_P95 = 1e-3, 5e-3
# The keypoint head alone against its plain version: coordinates in [0, 1]
# through delta heads of 0.02, where a flipped bf16 rounding of a hidden
# value moves a coordinate by about 1e-5.
KPT_MAX, KPT_MEAN = 2e-4, 1e-5
# Kernels and copies one call of the stack may launch: the k, v, kpos
# GEMMs, then per layer sine_feats, two ref_point_head GEMMs, the qkv
# GEMM, the bias attention, dec_post_self, the cross-attention,
# dec_post_cross and the keypoint head.
STACK_KERNELS = 3 + 9 * 3
# Uncached and 5-shot episodes: groups, queries per group, batch size.
EVAL_GROUPS, EVAL_QUERIES, EVAL_BATCH = 8, 4, 16
# Strict fp32 on the card against the CPU: fp32 on both sides, summed in
# another order through 12 trunk blocks and the head; TF32 (10 mantissa
# bits) would show as 1e-3 on the trunk's features.
STRICT_MEDIAN, STRICT_P99 = 1e-4, 2e-3
# The ViT block's kernels (ops/kernels.py vit_qkv, vit_attn, vit_mlp): the
# first two are the attention half, and #10 fused_attn_block's call.
VIT_KERNELS = ("vit_qkv_kernel", "vit_attn_kernel", "vit_mlp_kernel")
# the GEMM's kernels by mainloop (TMA + wgmma, thread-copy), and those the
# variant path counts (ops/kernels.py launches)
GEMMS = ("gemm_tma_kernel", "gemm_kernel")
VARIANT_KERNELS = ("bias_attn_kernel", "kpt_head_kernel") + VIT_KERNELS

# Training phase: batch, steps of the stage-3 fit (the first is warm-up),
# steps of the plain-path and stage-2 trainers, dropout, the keep share's
# band around 1 - rate for the 1.3-16 million mask elements of a call.
TRAIN_B, TRAIN_STEPS, SIDE_STEPS, DROPOUT, KEEP_BAND = 16, 6, 3, 0.1, 0.005
# Kernel-path gradients against the plain path (fp32 attention, no bf16
# operand rounding; both over the same bf16 backbone features): relative
# L2 error over all trainable gradients, and per tensor for tensors that
# carry at least a thousandth of the largest norm. bf16 operands give
# about 2^-8 per product; the local soft-argmax window can move on a near
# tie and change a keypoint's gradient, hence L2 and not max norms.
GRAD_REL_L2, GRAD_TENSOR_REL_L2 = 0.05, 0.25
# mm_chain against its plain version: a bf16 output after up to 6 residual
# steps, each of which rounds h and x to bf16; the two sum in different
# orders, so single roundings flip (one bf16 ulp is 2^-8 of a value) and
# are carried through the later steps. Max error within 2^-6 of the
# output's largest magnitude, mean error within 0.5% of its mean magnitude
# (measured: 0.0047 and 0.0021).
MM_MAX_REL, MM_MEAN_REL = 2.0 ** -6, 5e-3
MM_SMALL = ("small b=6 g=3 n=70 c=256 f=192 reps=3", 6, 3, 70, 256, 192, 3)
# Disk path: classes and images per class of the synthetic stand-in (256 px
# sources), test episodes per class, training epochs (the first one warms
# up), the bound on the PCK difference between the cached loop (bf16 head)
# and the uncached one (fp32 head) on the same checkpoint and episodes
# (measured 0.0013 over 480 query images).
DISK_CLASSES, DISK_IMAGES, DISK_EPISODES, DISK_EPOCHS = 8, 16, 4, 2
DISK_PCK_TOL = 0.01


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


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


# ------------------------------------------------------------ config
def bound(n_bytes: float, flops: float, f32_flops: float = 0.0):
    """(bound_ms, bound_by) of a kernel that must move n_bytes and do
    flops bf16 tensor-core operations and f32_flops fp32 ones."""
    t_bytes = n_bytes / PEAK_BYTES_S
    t_ops = flops / PEAK_BF16_FLOPS + f32_flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def finite(obj):
    """obj with every nan or infinite float replaced by None (a measurement
    that was not taken), so that the kernels line is strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def param_bytes(*modules) -> int:
    return sum(nbytes(*m.parameters()) for m in modules)


def seeded_randn(seed, dev):
    """rn(*shape, s=1.0): normal draws of scale s from one seeded host
    generator, moved to dev."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)
    return g, rn


def randomize(module, rn, dev):
    """Seeded weights for an op check: LayerScale 1 (so every sub-step
    shows), matrices at 1 / sqrt(fan-in), LayerNorm scales about 1, small
    non-zero biases, the kpt_branch delta heads at 0.02."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("ls1", "ls2")):
                p.fill_(1.0)
            elif ".out." in name or name.startswith("out."):
                p.copy_(rn(*p.shape, s=0.02))
            elif p.dim() == 2:
                p.copy_(rn(*p.shape, s=1.0 / math.sqrt(p.shape[1])))
            elif name.endswith("weight"):      # LayerNorm scale
                p.copy_(1.0 + rn(*p.shape, s=0.1))
            else:
                p.copy_(rn(*p.shape, s=0.1))
    return module.to(dev).eval()


def check_op(entries, bad, name, replaces, op_src, out, ref, kern, plain,
             bnd, library=None, counter=None, extra="", copy_gemms=None,
             tma_gemms=None):
    """One [op] line and one entry of the kernels line: the kernel's
    output `out` against the plain version's `ref` within ATOL + RTOL *
    |ref| (mean within MEAN_TOL), the times of kern() and plain() and of
    the library call, the bound `bnd`. counter: (module, attribute) of the
    op's launch counter, which one call of kern() must raise by one. The
    line also says how many GEMMs of one call took the TMA + wgmma
    mainloop and how many the thread-copy loader; copy_gemms: how many
    may take the latter (operands a tensor map cannot describe);
    tma_gemms: how many must take the former."""
    from edgecape_tpu_torch.ops import kernels as KN
    before = dict(KN.launches)
    kern()
    gemms = {k: KN.launches[k] - before[k] for k in GEMMS}
    tma, copy = gemms["gemm_tma_kernel"], gemms["gemm_kernel"]
    per_call = f"; GEMMs per call: {tma} TMA + wgmma, {copy} thread-copy"
    if copy_gemms is not None and copy != copy_gemms:
        bad.append(f"{name}: {copy} GEMMs took the thread-copy "
                   f"loader, {copy_gemms} may")
    if tma_gemms is not None and tma != tma_gemms:
        bad.append(f"{name}: {tma} TMA GEMMs per call, "
                   f"{tma_gemms} expected")
    if counter is not None:
        n0 = getattr(*counter)
        kern()
        n = getattr(*counter) - n0
        per_call += f"; {n} launch counted per call"
        if n != 1:
            bad.append(f"{name}: {n} counted launches for one call")
    torch.cuda.synchronize()
    d = (out.float() - ref.float()).abs()
    excess = (d - (ATOL + RTOL * ref.float().abs())).max().item()
    err, mean = d.max().item(), d.mean().item()
    ok = excess <= 0 and mean <= MEAN_TOL and bool(
        torch.isfinite(out.float()).all())
    ms, plain_ms = time_ms(kern), time_ms(plain)
    lib_ms = time_ms(library) if library is not None else None
    print(f"[op] {name}: shape {tuple(out.shape)} max_abs_err {err:.4g} "
          f"mean_abs_err {mean:.3g} (tol {ATOL} + {RTOL:.4g}*|ref|, mean "
          f"{MEAN_TOL}; worst excess {excess:.3g}) kernel {ms:.3f} ms "
          f"plain {plain_ms:.3f} ms bound {bnd[0]:.4f} ms ({bnd[1]}) "
          f"library {'none' if lib_ms is None else f'{lib_ms:.3f} ms'}"
          f"{per_call}{extra} {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        bad.append(name)
    entries[name] = {"name": name, "route": "cuda",
                     "source": "edgecape_tpu_torch/csrc/kernels.cu",
                     "op": op_src, "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": lib_ms, "gemms_per_call": gemms}


def device_extra(name, kern, cap, bad, must_run=()):
    """The [op] line's device part: device time and kernels per call of
    kern() (profiler) and ms a call by kernel. Where the traces lose their
    device events (tools/bench_attention.py device_ms), the count comes
    from the wrappers' exact launch counters (ops/kernels.py
    launch_counts) and the time is "not measured" beside the CUDA-event
    wall time. Fails the op when a call launches more than `cap` kernels,
    when a kernel named in must_run ran neither in the trace nor by the
    counters, or when neither source gives a count: a missing count is
    never a pass. Returns (text, device ms or None, kernels per call or
    None, {kernel: ms a call} of the trace)."""
    from edgecape_tpu_torch.tools import bench_attention as BA
    dev_ms, per_call, wall_ms, count_from = BA.per_call(kern)
    by_name = BA.kernel_ms(kern)
    ran = set(by_name) | set(BA.launched(kern))
    by_kernel = ", ".join(
        f"{k.split('(')[0].replace('void ', '')} {ms:.4f}"
        for k, ms in sorted(by_name.items(), key=lambda kv: -kv[1]))
    if per_call is None:
        bad.append(f"{name}: no kernel count (the traces lost their device "
                   f"events and no launch counter moved)")
    elif per_call > cap:
        bad.append(f"{name}: {per_call} kernels per call")
    missing = [n for n in must_run if not any(n in k for k in ran)]
    if missing:
        bad.append(f"{name}: {missing} did not run")
    return (f"; {BA.ms_text(dev_ms, wall_ms)} in {per_call} kernels per "
            f"call by {count_from} (at most {cap}; ms a call by kernel: "
            f"{by_kernel or 'not measured'})", dev_ms, per_call, by_name)


def main_path_config():
    """The stage-3 eval configuration of the main path: learned skeleton
    and Markov bias, K=100, 224 px, bf16 compute and head dtype."""
    from edgecape_tpu_torch.config import Config, ModelConfig
    return Config(model=ModelConfig(
        image_size=SIZE, max_kpt=K, learn_skeleton=True, attn_bias=True,
        max_hops=4, compute_dtype="bfloat16", head_dtype="bfloat16",
        use_flash=True))


# ------------------------------------------------------------ phase 2
def library_encoder(layers, c, ffn, dev, dtype=torch.bfloat16):
    """nn.TransformerEncoderLayer copies of the port's encoder layers in
    `dtype`, eval mode: the one PyTorch call that computes a post-norm ReLU
    layer with a key padding mask."""
    out = []
    with torch.no_grad():
        for layer in layers:
            at = layer.self_attn
            lib = torch.nn.TransformerEncoderLayer(
                c, 8, ffn, dropout=0.0, batch_first=True)
            lib.self_attn.in_proj_weight.copy_(torch.cat(
                [at.q_proj.weight, at.k_proj.weight, at.v_proj.weight]))
            lib.self_attn.in_proj_bias.copy_(torch.cat(
                [at.q_proj.bias, at.k_proj.bias, at.v_proj.bias]))
            for dst, src in ((lib.self_attn.out_proj, at.out_proj),
                             (lib.linear1, layer.linear1),
                             (lib.linear2, layer.linear2),
                             (lib.norm1, layer.norm1),
                             (lib.norm2, layer.norm2)):
                dst.weight.copy_(src.weight)
                dst.bias.copy_(src.bias)
            out.append(lib.to(dev, dtype).eval())
    return out


def fast_path_taken(fn) -> bool:
    """Did fn() go through torch._transformer_encoder_layer_fwd?"""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return any("_transformer_encoder_layer_fwd" in e.key
               for e in prof.key_averages())


def op_checks(dev, entries):
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    import edgecape_tpu_torch.ops.fused_vit_block as FV
    import edgecape_tpu_torch.ops.flash_attention as FA
    from edgecape_tpu_torch.models.dinov2 import VIT_S14, Block
    from edgecape_tpu_torch.models.transformer import (DecoderLayer,
                                                       EncoderLayer)

    g, rn = seeded_randn(SEED, dev)
    nq, hw, c, ffn = GROUPS * QUERIES, 256, 256, 384
    bf = torch.bfloat16
    blk = randomize(Block(VIT_S14), rn, dev)
    x = rn(nq, 257, 384).to(bf)
    enc = [randomize(EncoderLayer(c, 8, ffn), rn, dev) for _ in range(3)]
    tok = rn(nq, hw + K, c).to(bf)
    pos = rn(hw + K, c).to(bf)
    valid = torch.rand(nq, hw + K, generator=g).to(dev) > 0.2
    valid[:, :hw] = True
    dec = randomize(DecoderLayer(c, 8, ffn, attn_bias=True), rn, dev)
    kx, qpos = rn(nq, K, c).to(bf), rn(nq, K, c).to(bf)
    img, ipos = rn(nq, hw, c).to(bf), rn(hw, c).to(bf)
    kvalid = torch.rand(nq, K, generator=g).to(dev) > 0.3
    kvalid[:, 0] = True
    bias = rn(nq, 8, K, K)
    adj = torch.rand(nq, 2, K, K, generator=g).to(dev) / K
    fq, fk, fv = (rn(GROUPS, K, 8, 32) for _ in range(3))
    fvalid = kvalid[:GROUPS]

    def plain_stack():
        x = tok
        for layer in enc:
            x = FE.fused_encoder_layer_plain(x, pos, valid, layer,
                                             num_heads=8)
        return x

    def stack_pairs():
        """The stack's output must be the chain of layer launches, and each
        layer launch must match the plain layer on the same input."""
        x, outs, refs = tok, [], []
        for layer in enc:
            refs.append(FE.fused_encoder_layer_plain(x, pos, valid, layer,
                                                     num_heads=8))
            x = FE.fused_encoder_layer(x, pos, valid, layer, num_heads=8)
            outs.append(x)
        if not torch.equal(FE.fused_encoder_stack(tok, pos, valid, enc,
                                                  num_heads=8), x):
            fail("fused_encoder_stack differs from its chain of layers")
        return torch.stack(outs), torch.stack(refs)

    # least work of each op: bytes = operands and parameters read once +
    # output written once; operations = its matrix products (2 per
    # multiply-add)
    n_tok, c_vit, c_hd = 257, 384, c
    bounds = {
        "fused_vit_block": bound(
            2 * nbytes(x) + param_bytes(blk),
            2 * nq * n_tok * 12 * c_vit ** 2 + 4 * nq * n_tok ** 2 * c_vit),
        "fused_encoder_stack": bound(
            2 * nbytes(tok) + nbytes(pos, valid) + param_bytes(*enc),
            3 * (2 * nq * (hw + K) * (4 * c_hd ** 2 + 2 * c_hd * ffn)
                 + 4 * nq * (hw + K) ** 2 * c_hd)),
        "fused_decoder_layer": bound(
            2 * nbytes(kx) + nbytes(qpos, img, ipos, kvalid, bias, adj)
            + param_bytes(dec),
            # self-attention; cross-attention at 2C (q, out and choker on
            # K tokens, k and v on the image tokens); GCN and ffn2
            2 * nq * K * 4 * c_hd ** 2 + 4 * nq * K * K * c_hd
            + 2 * nq * K * (4 + 4 + 2) * c_hd ** 2
            + 2 * nq * hw * (2 + 2) * c_hd ** 2 + 4 * nq * K * hw * 2 * c_hd
            + 2 * nq * K * (2 * c_hd * ffn + ffn * c_hd)
            + 2 * nq * 2 * K * K * ffn),
        "flash_mha": bound(nbytes(fq, fk, fv, fvalid) + nbytes(fq),
                           4 * GROUPS * 8 * K * K * 32),
    }
    # the one PyTorch call that computes flash_mha: SDPA with a key mask
    sq, sk, sv = (t.transpose(1, 2).to(bf) for t in (fq, fk, fv))
    smask = torch.zeros(GROUPS, 1, 1, K, device=dev, dtype=bf).masked_fill(
        ~fvalid[:, None, None, :], -math.inf)
    lib_enc = library_encoder(enc, c, ffn, dev)
    pad = ~valid

    def library_stack():
        """The same post-norm ReLU layers on src = tokens + pos (added once,
        where the op adds it per layer) through nn.TransformerEncoderLayer."""
        with torch.inference_mode():
            x = tok + pos
            for layer in lib_enc:
                x = layer(x, src_key_padding_mask=pad)
        return x

    library = {"flash_mha": lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=smask),
        "fused_encoder_stack": library_stack}

    # (name, TPU kernel's pallas_call, op module, kernel, plain,
    #  (kernel output, plain output) to compare)
    cases = [
        ("fused_vit_block", "edgecape_tpu/ops/fused_vit_block.py:157",
         "edgecape_tpu_torch/ops/fused_vit_block.py",
         lambda: FV.fused_vit_block(x, blk, num_heads=6, eps=1e-6),
         lambda: FV.fused_vit_block_plain(x, blk, num_heads=6, eps=1e-6),
         None),
        ("fused_encoder_stack", "edgecape_tpu/ops/fused_encoder.py:188",
         "edgecape_tpu_torch/ops/fused_encoder.py",
         lambda: FE.fused_encoder_stack(tok, pos, valid, enc, num_heads=8),
         plain_stack, stack_pairs),
        ("fused_decoder_layer", "edgecape_tpu/ops/fused_decoder.py:262",
         "edgecape_tpu_torch/ops/fused_decoder.py",
         lambda: FD.fused_decoder_layer(kx, qpos, img, ipos, kvalid, bias,
                                        adj, dec, num_heads=8),
         lambda: FD.fused_decoder_layer_plain(kx, qpos, img, ipos, kvalid,
                                              bias, adj, dec, num_heads=8),
         None),
        ("flash_mha", "edgecape_tpu/ops/flash_attention.py:132",
         "edgecape_tpu_torch/ops/flash_attention.py",
         lambda: FA.flash_mha(fq, fk, fv, fvalid),
         lambda: FA.flash_mha_plain(fq, fk, fv, fvalid), None),
    ]
    bad = []
    with torch.no_grad():
        fast = fast_path_taken(library_stack)
        # kernels and copies one call may put on the device: the ViT
        # block's 3 (vit_qkv_kernel, vit_attn_kernel, vit_mlp_kernel), the
        # stack's add_pos and 3 per layer (qkv GEMM, attention,
        # enc_post_kernel), the decoder layer's 8 (qkv, attention,
        # dec_post_self_kernel, kpos, k, v GEMMs, attention,
        # dec_post_cross_kernel); and the GEMMs of a ViT block (none)
        launch_cap = {"fused_vit_block": 3,
                      "fused_encoder_stack": 1 + 3 * len(enc),
                      "fused_decoder_layer": 8}
        must_run = {"fused_vit_block": VIT_KERNELS}
        tma_gemms = {"fused_vit_block": 0}
        for name, replaces, op_src, kern, plain, pairs in cases:
            out, ref = pairs() if pairs else (kern(), plain())
            extra, cap = "", launch_cap.get(name)
            if cap is not None:
                extra, dev_ms, per_call, _ = device_extra(
                    name, kern, cap, bad, must_run.get(name, ()))
            if name == "fused_encoder_stack":
                extra += (f"; library: {len(enc)} x nn.TransformerEncoderLayer"
                          f" (bf16, eval, inference mode), fast path "
                          f"{'taken' if fast else 'NOT taken'}")
            # every GEMM of these ops takes the TMA + wgmma mainloop
            check_op(entries, bad, name, replaces, op_src, out, ref, kern,
                     plain, bounds[name], library=library.get(name),
                     copy_gemms=0, tma_gemms=tma_gemms.get(name),
                     extra=extra)
            if cap is not None:
                entries[name].update(device_ms=dev_ms,
                                     kernels_per_call=per_call)
        # the training step runs fused_vit_block on its support and query
        # images together, another row count than the eval chunk's (other
        # GEMM tile counts and partial tiles): held at that shape too
        xt = rn(2 * TRAIN_B, n_tok, c_vit).to(bf)
        out = FV.fused_vit_block(xt, blk, num_heads=6, eps=1e-6)
        ref = FV.fused_vit_block_plain(xt, blk, num_heads=6, eps=1e-6)
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs()
        excess = (d - (ATOL + RTOL * ref.float().abs())).max().item()
        ok = excess <= 0 and d.mean().item() <= MEAN_TOL and bool(
            torch.isfinite(out).all())
        ms = time_ms(lambda: FV.fused_vit_block(xt, blk, num_heads=6,
                                                eps=1e-6))
        plain_ms = time_ms(lambda: FV.fused_vit_block_plain(
            xt, blk, num_heads=6, eps=1e-6))
        bound_ms, bound_by = bound(
            2 * nbytes(xt) + param_bytes(blk),
            2 * 2 * TRAIN_B * n_tok * 12 * c_vit ** 2
            + 4 * 2 * TRAIN_B * n_tok ** 2 * c_vit)
        print(f"[op] fused_vit_block at the training step's shape "
              f"{tuple(out.shape)}: max_abs_err {d.max().item():.4g} "
              f"mean_abs_err {d.mean().item():.3g} (tol {ATOL} + "
              f"{RTOL:.4g}*|ref|, mean {MEAN_TOL}; worst excess "
              f"{excess:.3g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"bound {bound_ms:.4f} ms ({bound_by}) library none "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append("fused_vit_block at the training step's shape")
    if bad:
        fail(f"kernel ops disagree with their plain versions: {bad}")


# ------------------------------------------------------------ phase 3
def episodes(rng):
    """CHUNKS chunks of GROUPS groups x QUERIES queries, in memory:
    uint8 images, support joints, query ground-truth joints, a chain
    skeleton with a few chords, some keypoints invisible."""
    adj = np.zeros((K, K), np.float32)
    for i in range(K - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1.0
    for i, j in rng.integers(0, K, size=(10, 2)):
        if i != j:
            adj[i, j] = adj[j, i] = 1.0
    nq = GROUPS * QUERIES
    out = []
    for _ in range(CHUNKS):
        vis = (rng.uniform(size=(GROUPS, 1, K)) > 0.1).astype(np.float32)
        support = {
            "img_s": rng.integers(0, 256, (GROUPS, 1, SIZE, SIZE, 3),
                                  dtype=np.uint8),
            "joints_s": rng.uniform(8, SIZE - 8, (GROUPS, 1, K, 2)).astype(
                np.float32),
            "vis_s": vis,
            "binary_adj": np.tile(adj, (GROUPS, 1, 1))}
        group = np.repeat(np.arange(GROUPS, dtype=np.int32), QUERIES)
        query = {"img_q": rng.integers(0, 256, (nq, SIZE, SIZE, 3),
                                       dtype=np.uint8),
                 "group": group,
                 "joints_q": rng.uniform(8, SIZE - 8, (nq, K, 2)).astype(
                     np.float32),
                 "weight_q": vis[group, 0]}
        meta = {"query_center": np.full((nq, 2), SIZE / 2, np.float32),
                "query_scale": np.full((nq, 2), SIZE / 200.0, np.float32)}
        out.append((support, query, meta))
    return out


def main_path(dev, entries, power):
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.eval.runner import pck_accuracy, run_cached
    from edgecape_tpu_torch.models.convert import (init_params,
                                                   redraw_zero_inits)
    from edgecape_tpu_torch.ops import affine
    from edgecape_tpu_torch.ops import kernels as KN
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    import edgecape_tpu_torch.ops.fused_vit_block as FV
    import edgecape_tpu_torch.ops.flash_attention as FA

    cfg = main_path_config()
    gen = torch.Generator().manual_seed(SEED)
    bb, head = init_params(gen, cfg.model)
    redraw_zero_inits(bb, head, gen)
    est = PoseEstimator(cfg, bb, head, device=dev)
    if not est.use_flash:
        fail("the estimator did not select the kernel path")
    data = episodes(np.random.default_rng(SEED))

    # warm-up on the first chunk (allocator, library handles); not counted
    est.forward_cached(data[0][0], data[0][1])
    torch.cuda.synchronize()

    preds = []

    def on_chunk(pred_host, query, meta, real):
        preds.append(pred_host)

    counters = [(FV, "launches"), (FE, "stack_launches"), (FE, "launches"),
                (FD, "launches"), (FA, "launches")]
    for mod, attr in counters:
        setattr(mod, attr, 0)
    KN.launches.update(dict.fromkeys(KN.launches, 0))
    t0 = time.perf_counter()
    timings = run_cached(est, [(i, GROUPS) for i in range(CHUNKS)],
                         lambda i: data[i], on_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gemms = {k: KN.launches[k] for k in GEMMS}
    counts = {"fused_vit_block": FV.launches,
              "fused_encoder_stack": FE.stack_launches,
              "fused_encoder_layer": FE.launches,
              "fused_decoder_layer": FD.launches,
              "flash_mha": FA.launches}
    expect = {"fused_vit_block": 24 * CHUNKS,
              "fused_encoder_stack": CHUNKS,
              "fused_encoder_layer": 3 * CHUNKS,
              "fused_decoder_layer": 3 * CHUNKS,
              "flash_mha": 3 * CHUNKS}
    # 3 x 1 GEMMs of the encoder layers (qkv), 3 x 4 of the decoder layers
    # (qkv, kpos, k, v), all on the TMA + wgmma mainloop, none in the ViT
    # blocks; one post-attention kernel of each kind a layer; one
    # vit_qkv_kernel and one vit_attn_kernel (the attention half) and one
    # vit_mlp_kernel (the MLP half) a ViT block
    expect_gemms = {"gemm_tma_kernel": (3 * 1 + 3 * 4) * CHUNKS,
                    "gemm_kernel": 0}
    expect_post = {"enc_post_kernel": 3 * CHUNKS,
                   "dec_post_self_kernel": 3 * CHUNKS,
                   "dec_post_cross_kernel": 3 * CHUNKS,
                   "vit_mlp_kernel": 24 * CHUNKS,
                   "vit_qkv_kernel": 24 * CHUNKS,
                   "vit_attn_kernel": 24 * CHUNKS}
    post = {k: KN.launches[k] for k in expect_post}
    print(f"[path] launches {counts} expected {expect}; GEMM launches by "
          f"mainloop {gemms} expected {expect_gemms}; post-attention and "
          f"MLP kernels {post} expected {expect_post}", flush=True)
    for name in ("fused_vit_block", "fused_encoder_stack",
                 "fused_decoder_layer", "flash_mha"):
        entries[name]["launches"] = counts[name]
    for k in ("vit_qkv_kernel", "vit_attn_kernel", "vit_mlp_kernel"):
        entries["fused_vit_block"][f"{k}_launches"] = post[k]
    if counts != expect:
        fail("launch counts differ from what the main path implies")
    if gemms != expect_gemms:
        fail("a GEMM of the main path did not take the mainloop it should")
    if post != expect_post:
        fail("the post-attention kernels did not run once a layer or the "
             "ViT kernels once a ViT block")

    nq = GROUPS * QUERIES
    bad = []
    pck_hits = []
    for (support, query, meta), pred in zip(data, preds):
        if pred.shape != (nq, K, 2):
            bad.append(f"shape {pred.shape}")
        if not np.isfinite(pred).all() or pred.min() < 0 or pred.max() > 1:
            bad.append("predictions not finite or outside [0, 1]")
        pix = affine.transform_preds_batch(pred * SIZE, meta["query_center"],
                                           meta["query_scale"], (SIZE, SIZE))
        pck_hits.append(pck_accuracy(pix, query["joints_q"],
                                     query["weight_q"] > 0,
                                     np.full((nq, 2), SIZE, np.float32),
                                     0.2))
    print(f"[path] {CHUNKS} chunks x {nq} queries: {wall:.3f} s, "
          f"{CHUNKS * nq / wall:.1f} img/s on {power} (information only; "
          f"host collate {timings['host_collate_s']:.3f} s, dispatch "
          f"{timings['dispatch_s']:.3f} s, device wait "
          f"{timings['device_wait_s']:.3f} s); PCK@0.2 on random weights "
          f"{float(np.mean(pck_hits)):.4f}", flush=True)
    if bad:
        fail("; ".join(bad))

    # one chunk on the plain (no kernel) path, same weights, on the card
    cfg.model.use_flash = False
    plain = PoseEstimator(cfg, bb, head, device=dev)
    ref, _ = plain.forward_cached(data[0][0], data[0][1])
    d = np.abs(ref.cpu().numpy() - preds[0])
    med, within = float(np.median(d)), float(np.mean(d <= PATH_CELL))
    ok = med <= PATH_MEDIAN_TOL and within >= PATH_WITHIN_SHARE
    print(f"[path] chunk 0 vs plain path: median |d| {med:.4g} (tol "
          f"{PATH_MEDIAN_TOL}), max {d.max():.4g}, share within "
          f"{PATH_CELL:.4g}: {within:.4f} (tol >= {PATH_WITHIN_SHARE}) "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("main path disagrees with the plain path")
    t0 = time.perf_counter()
    run_cached(plain, [(i, GROUPS) for i in range(CHUNKS)],
               lambda i: data[i], lambda *a: None)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    print(f"[path] plain path (no kernels), same {CHUNKS} chunks: "
          f"{plain_wall:.3f} s, {CHUNKS * nq / plain_wall:.1f} img/s on "
          f"{power} (information only)", flush=True)
    # the image copies: through the estimator's pinned buffers (as above)
    # against plain copies from pageable memory, the same chunks in turns
    def chunks_wall():
        t0 = time.perf_counter()
        run_cached(est, [(i, GROUPS) for i in range(CHUNKS)],
                   lambda i: data[i], lambda *a: None)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {"pinned": [], "pageable": []}
    staged_before = est._stage.staged
    min_bytes = est._stage.min_bytes
    for _ in range(2):
        walls["pinned"].append(chunks_wall())
        est._stage.min_bytes = float("inf")
        walls["pageable"].append(chunks_wall())
        est._stage.min_bytes = min_bytes
    staged = est._stage.staged - staged_before
    print(f"[path] host-to-device copies of the same {CHUNKS} chunks, best "
          f"of 2 in turns: through pinned buffers "
          f"{CHUNKS * nq / min(walls['pinned']):.1f} img/s ({staged} staged "
          f"copies in 2 runs), from pageable memory "
          f"{CHUNKS * nq / min(walls['pageable']):.1f} img/s on {power} "
          f"(information only)", flush=True)
    # per chunk: the query images, the support images and the adjacency
    # stack (1.4 MB) are large enough to be staged
    if staged != 2 * 3 * CHUNKS:
        fail("the chunk's images did not go through the pinned buffers")
    profile(lambda: est.forward_cached(data[1][0], data[1][1]),
            "one chunk of the kernel path", power)
    return est, data, preds, (bb, head)


def profile(run, what, power, rows=30):
    """Prints device time by kernel over one warm call of run() (one
    chunk of the eval kernel path, or one training step), and the share
    of its wall time (call to synchronize) in which the device ran a
    kernel or a copy: the union of those intervals in the profiler's
    trace."""
    import os
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("ph") == "X" and "dur" in e and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, -math.inf
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy = (f"device busy {busy_us / 1e3:.3f} ms in {len(spans)} kernels "
            f"and copies, idle share {1.0 - busy_us / wall_us:.4f}"
            if spans else "device busy share not measured (no device "
            "events in the trace)")
    print(f"[profile] {what} on {power}: wall "
          f"{wall_us / 1e3:.3f} ms (profiler on), {busy}", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=rows), flush=True)


# ------------------------------------------- training attention op checks
def close(name, out, ref):
    """(ok, max abs error, worst excess over the tensor's bound, relative
    L2 error). The bound is ATOL + RTOL * |ref| for the output, GRAD_ATOL
    + RTOL * |ref| for dq, dk, dv and DBIAS_ATOL for dbias; the relative
    L2 error must stay within TENSOR_REL_L2 for all of them."""
    out, ref = out.float(), ref.float()
    d = (out - ref).abs()
    if name == "dbias":
        limit = torch.full_like(ref, DBIAS_ATOL)
    else:
        limit = (ATOL if name == "out" else GRAD_ATOL) + RTOL * ref.abs()
    excess = (d - limit).max().item()
    rel = ((out - ref).norm() / ref.norm()).item()
    ok = excess <= 0 and rel <= TENSOR_REL_L2 and bool(
        torch.isfinite(out).all())
    return ok, d.max().item(), excess, rel


def train_op_checks(dev, entries):
    """flash_mha_train at its three call sites in one training step of
    the reference batch (16 episodes, 1 shot, K=100, 8 heads of 32)."""
    import edgecape_tpu_torch.ops.flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as KN

    g = torch.Generator().manual_seed(SEED + 1)
    bsz, h, d = TRAIN_B, 8, 32
    sites = [("skeleton refine self-attention", K, False),
             ("joint encoder self-attention", 256 + K, False),
             ("decoder self-attention (Markov bias)", K, True)]
    bad = []
    rows = {"fwd": [], "bwd": []}
    for site, n, with_bias in sites:
        q, k, v, go = ((torch.randn(bsz, n, h, d, generator=g)).to(dev)
                       for _ in range(4))
        valid = (torch.rand(bsz, n, generator=g) > 0.2).to(dev)
        valid[:, 0] = True
        bias = torch.randn(bsz, h, n, n, generator=g).to(dev) \
            if with_bias else None

        def run(fn, **kw):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            bl = None if bias is None else bias.clone().requires_grad_(True)
            out = fn(*leaves, valid, bl, **kw)
            grads = torch.autograd.grad(
                out, leaves + ([bl] if bl is not None else []), go)
            return out.detach(), grads

        def gen(seed):
            return torch.Generator(device=dev).manual_seed(seed)

        errs, rels = {}, {}
        # rate 0: forward and gradients against autograd through the plain
        out, grads = run(FA.flash_mha_train)
        ref, rgrads = run(FA.flash_mha_train_plain)
        torch.cuda.synchronize()
        names = ["out", "dq", "dk", "dv"] + (["dbias"] if with_bias else [])
        for name, a, r in zip(names, (out,) + tuple(grads),
                              (ref,) + tuple(rgrads)):
            ok, err, excess, rel = close(name, a, r)
            errs[name], rels[name] = err, rel
            if not ok:
                bad.append(f"{site}: {name} at rate 0 (err {err:.3g}, "
                           f"excess {excess:.3g}, relative L2 {rel:.3g})")
        # rate 0.1: against the plain version fed the kernels' own mask
        seed = FA.dropout_seed(gen(11), dev)
        keep = KN.dropout_mask(seed, DROPOUT, bsz * h, n, n).reshape(
            bsz, h, n, n)
        share = keep.float().mean().item()
        if abs(share - (1.0 - DROPOUT)) > KEEP_BAND:
            bad.append(f"{site}: keep share {share:.4f}")
        outd, gradsd = run(FA.flash_mha_train, dropout_rate=DROPOUT,
                           generator=gen(11))
        refd, rgradsd = run(FA.flash_mha_train_plain, dropout_rate=DROPOUT,
                            keep=keep)
        for name, a, r in zip(names, (outd,) + tuple(gradsd),
                              (refd,) + tuple(rgradsd)):
            ok, err, excess, rel = close(name, a, r)
            errs[name + "@drop"], rels[name + "@drop"] = err, rel
            if not ok:
                bad.append(f"{site}: {name} at rate {DROPOUT} (err "
                           f"{err:.3g}, excess {excess:.3g}, relative L2 "
                           f"{rel:.3g})")
        again, _ = run(FA.flash_mha_train, dropout_rate=DROPOUT,
                       generator=gen(11))
        other_seed = FA.dropout_seed(gen(12), dev)
        other = KN.dropout_mask(other_seed, DROPOUT, bsz * h, n, n).reshape(
            bsz, h, n, n)
        if not torch.equal(outd, again):
            bad.append(f"{site}: the same seed gave another output")
        if torch.equal(keep, other):
            bad.append(f"{site}: another seed gave the same mask")

        # times: forward alone; backward alone (the graph kept)
        def timers(fn, **kw):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            bl = None if bias is None else bias.clone().requires_grad_(True)
            wrt = leaves + ([bl] if bl is not None else [])
            out = fn(*leaves, valid, bl, **kw)
            with torch.no_grad():
                fwd = time_ms(lambda: fn(q, k, v, valid, bias, **kw))
            bwd = time_ms(lambda: torch.autograd.grad(out, wrt, go,
                                                      retain_graph=True))
            return fwd, bwd

        fwd_ms, bwd_ms = timers(FA.flash_mha_train)
        pfwd_ms, pbwd_ms = timers(FA.flash_mha_train_plain)
        dfwd_ms, dbwd_ms = timers(FA.flash_mha_train, dropout_rate=DROPOUT,
                                  generator=gen(13))
        # library yardstick: SDPA on the same shapes at rate 0 (bf16
        # operands, additive mask holding the key mask and the bias;
        # gradients for q, k, v); used by nothing
        bf = torch.bfloat16
        sq, sk, sv = (t.transpose(1, 2).to(bf).requires_grad_(True)
                      for t in (q, k, v))
        mask = torch.zeros(bsz, 1, 1, n, device=dev).masked_fill(
            ~valid[:, None, None, :], -math.inf)
        if bias is not None:
            mask = mask + bias
        mask = mask.to(bf)
        sgo = go.transpose(1, 2).to(bf)
        sout = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask)
        with torch.no_grad():
            lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask))
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            sout, (sq, sk, sv), sgo, retain_graph=True))

        # least work: q, k, v, mask and bias read once, out and the row
        # statistics written (forward); the same inputs, do and the
        # statistics read, dq, dk, dv, dbias written (backward); 2 and 5
        # matrix products of 2 * N * N * D operations per head
        stats_b = bsz * h * n * 2 * 4
        in_b = nbytes(q, k, v, valid, bias)
        prod = 2.0 * bsz * h * n * n * d
        fb = bound(in_b + nbytes(q) + stats_b, 2 * prod)
        bb = bound(in_b + nbytes(go) + stats_b + nbytes(q, k, v, bias),
                   5 * prod)
        print(f"[op] flash_mha_train, {site}: q/k/v [{bsz}, {n}, {h}, {d}]"
              f"{' + bias' if with_bias else ''}: max_abs_err "
              + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in errs.items())
              + f" (tol out {ATOL} + {RTOL:.4g}*|ref|, dq dk dv {GRAD_ATOL} "
              f"+ {RTOL:.4g}*|ref|, dbias {DBIAS_ATOL}); relative L2 "
              + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in rels.items())
              + f" (tol {TENSOR_REL_L2}); keep share {share:.4f} "
              f"(band {1 - DROPOUT} +- {KEEP_BAND}); at rate 0: forward "
              f"kernel {fwd_ms:.3f} ms plain {pfwd_ms:.3f} ms bound "
              f"{fb[0]:.4f} ms ({fb[1]}) SDPA {lib_fwd:.3f} ms; backward "
              f"kernel {bwd_ms:.3f} ms plain {pbwd_ms:.3f} ms bound "
              f"{bb[0]:.4f} ms ({bb[1]}) SDPA {lib_bwd:.3f} ms; at rate "
              f"{DROPOUT}: forward kernel {dfwd_ms:.3f} ms, backward kernel "
              f"{dbwd_ms:.3f} ms", flush=True)
        fwd_err = max(errs["out"], errs["out@drop"])
        bwd_err = max(v_ for k_, v_ in errs.items()
                      if not k_.startswith("out"))
        rows["fwd"].append((site, n, with_bias, fwd_err, fwd_ms, pfwd_ms,
                            fb, lib_fwd, dfwd_ms))
        rows["bwd"].append((site, n, with_bias, bwd_err, bwd_ms, pbwd_ms,
                            bb, lib_bwd, dbwd_ms))
    if bad:
        fail("flash_mha_train disagrees with its plain version: "
             + "; ".join(bad))
    # one entry per kernel: the numbers of its largest call site (the
    # joint encoder), the others listed beside them
    for direction, line in (("fwd", 321), ("bwd", 361)):
        main = max(rows[direction], key=lambda r: r[1])
        _, n, _, err, ms, plain_ms, bnd, lib, _ = main
        entries[f"flash_mha_train_{direction}"] = {
            "name": f"flash_mha_train_{direction}", "route": "cuda",
            "source": "edgecape_tpu_torch/csrc/kernels.cu",
            "op": "edgecape_tpu_torch/ops/flash_attention.py",
            "replaces": f"edgecape_tpu/ops/flash_attention.py:{line}",
            "launches": 0,
            "max_abs_err": max(r[3] for r in rows[direction]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib,
            "shape": [TRAIN_B, n, 8, 32],
            "sites": [{"site": r[0], "n": r[1], "bias": r[2], "ms": r[4],
                       "plain_ms": r[5], "bound_ms": r[6][0],
                       "library_ms": r[7], "ms_with_dropout": r[8]}
                      for r in rows[direction]]}


def attention_checks(dev, entries, power):
    """The `[op] attention` lines: ops/kernels.py attention and
    flash_mha_train's forward at every shape of the eval and training
    paths (tools/bench_attention.py SHAPES), each held against its plain
    version; the rows go into the flash_mha entry of the kernels line."""
    from edgecape_tpu_torch.tools import bench_attention as BA
    if (BA.ATOL, BA.RTOL, BA.MEAN_TOL) != (ATOL, RTOL, MEAN_TOL):
        fail("tools/bench_attention.py holds another tolerance")
    rows, bwd_rows = [], []
    for spec in BA.SHAPES:
        rows.append(BA.run_case(spec, dev, power))
        if spec[-1] is not None:
            bwd_rows.append(BA.run_bwd_case(spec, dev, power))
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows + bwd_rows if not r["ok"]]
    if bad:
        fail(f"attention kernels disagree with their plain versions: {bad}")
    # a backward is its two kernels and nothing else: no mask pass, no copy
    # (the count from the launch counters where the traces lost their
    # device events; none at all fails)
    extra = [r["name"] for r in bwd_rows if r["kernels_per_call"] != 2]
    if extra:
        fail(f"the attention backward is not two kernels a call: {extra}")
    entries["flash_mha"]["attention_shapes"] = rows
    entries["flash_mha_train_bwd"]["attention_shapes"] = bwd_rows


def gemm_checks(dev, entries, power):
    """The `[op] gemm` lines: the GEMM behind the fused ops at the paths'
    shapes (tools/bench_gemm.py SHAPES), both mainloops against a float64
    reference, with their times, the bound and torch.matmul beside them;
    the rows go into the fused_vit_block entry of the kernels line."""
    from edgecape_tpu_torch.tools import bench_gemm as BG
    rows = []
    for spec in BG.SHAPES:
        rows.append(BG.run_case(spec, dev, power))
        torch.cuda.empty_cache()
    bad = [r["name"] for r in rows if not r["ok"]]
    if bad:
        fail(f"the GEMM disagrees with the float64 reference: {bad}")
    wrong = [r["name"] for r in rows
             if (r["mainloop"] == "tma") != (r["shape"][2] >= 32
                                             and r["shape"][3] % 8 == 0)]
    if wrong:
        fail(f"the GEMM's dispatch took another mainloop than the operands "
             f"imply: {wrong}")
    entries["fused_vit_block"]["gemm_shapes"] = rows


def width_check(dev, power):
    """A head of d_model 128 in 4 heads (num_feats 64) over a two-block
    ViT-S/14, asked for on the card with use_flash on: the post-attention
    kernels take 256 channels, so building the estimator raises ValueError
    (ops/kernel_config.py require_widths) naming the encoder stack, the
    decoder layer and the decoder stack with the width, before anything
    is built or launched: no forward pass raises half way. The main path's
    stage-3 widths were built without raising."""
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.config import Config, ModelConfig
    from edgecape_tpu_torch.models.dinov2 import DinoV2Config
    from edgecape_tpu_torch.tools import bench_attention as BA

    cfg = Config(model=ModelConfig(
        image_size=SIZE, max_kpt=K, learn_skeleton=True, attn_bias=True,
        max_hops=4, compute_dtype="bfloat16", head_dtype="bfloat16",
        use_flash=True, d_model=128, nhead=4, num_feats=64,
        similarity_proj_dim=128))
    err = []

    def build():
        try:
            PoseEstimator(cfg, generator=torch.Generator().manual_seed(SEED),
                          device=dev, backbone_cfg=DinoV2Config(depth=2))
        except ValueError as e:
            err.append(str(e))

    ran = BA.launched(build)
    msg = err[0] if err else ""
    named = [op for op in ("fused_encoder_stack", "fused_decoder_layer",
                           "fused_decoder_stack") if op in msg]
    ok = len(named) == 3 and "256 channels, got 128" in msg and not ran
    print(f"[widths] d_model 128, 4 heads, num_feats 64, use_flash on the "
          f"card: the build raised {bool(err)} naming {named} "
          f"({msg or 'no error'}); hand-written launches {sum(ran.values())}"
          f"; the main path's stage-3 widths built on {power} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("a model of other widths was not refused when it was built")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4
def train_config(work_dir):
    """Stage-1 ('base') training configuration at full width; the stage-2
    and stage-3 configurations are derived from it by the port's
    stage2_config / stage3_config."""
    from edgecape_tpu_torch import config as C
    cfg = main_path_config()
    # the head trains in fp32
    cfg.model = C.replace(cfg.model, compute_dtype="float32",
                          head_dtype="float32", learn_skeleton=False,
                          attn_bias=False, dropout=DROPOUT)
    cfg.train = C.TrainConfig(
        total_epochs=1, lr=1e-4, warmup_iters=2, warmup_ratio=0.001,
        batch_size=TRAIN_B, eval_interval=1000, ckpt_interval=1000,
        log_interval=1, seed=SEED, num_workers=1, tensorboard=False)
    cfg.work_dir = work_dir
    return cfg


class RefedBatch:
    """Dataset and loader in one, in memory: every step of an epoch gets
    the same batch of TRAIN_B one-shot episodes (normalised float images,
    a chain skeleton with chords, some keypoints invisible, half of the
    keypoints masked for the reconstruction branch)."""
    num_shots = 1

    def __init__(self, steps, rng):
        self.steps = steps
        f32 = np.float32
        adj = np.zeros((K, K), f32)
        for i in range(K - 1):
            adj[i, i + 1] = adj[i + 1, i] = 1.0
        for i, j in rng.integers(0, K, size=(10, 2)):
            if i != j:
                adj[i, j] = adj[j, i] = 1.0
        b = TRAIN_B
        vis = (rng.uniform(size=(b, 1, K)) > 0.1).astype(f32)
        self.batch = {
            "img_s": rng.normal(size=(b, 1, SIZE, SIZE, 3)).astype(f32),
            "img_q": rng.normal(size=(b, SIZE, SIZE, 3)).astype(f32),
            "joints_s": rng.uniform(8, SIZE - 8, (b, 1, K, 2)).astype(f32),
            "vis_s": vis,
            "target_q": np.zeros((b, K, 64, 64), f32),
            "weight_q": (rng.uniform(size=(b, K)) > 0.1).astype(f32),
            "joints_q": rng.uniform(8, SIZE - 8, (b, K, 2)).astype(f32),
            "binary_adj": np.tile(adj, (b, 1, 1)),
            "rand_mask": (rng.uniform(size=(b, K)) > 0.5).astype(f32)}

    def __len__(self):
        return self.steps * TRAIN_B

    def resample_episodes(self):
        pass

    def epoch(self):
        for _ in range(self.steps):
            yield self.batch


class EvalEpisodes:
    """In-memory validation set with the dataset interface the port's
    eval loops read (eval/runner.py): a few episode groups of `shots`
    support images and `queries` query images each (uint8, kept, so the
    cached and the uncached loop see the same episodes), with crop boxes
    covering the whole image."""
    img_prefix = "."
    name2id = {}

    def __init__(self, rng, groups=4, queries=3, shots=1):
        from edgecape_tpu_torch.config import DataConfig
        self.cfg = DataConfig()
        self.queries, self.shots = queries, shots
        adj = np.zeros((K, K), np.float32)
        for i in range(K - 1):
            adj[i, i + 1] = adj[i + 1, i] = 1.0
        self.adj = adj

        def item():
            return {"joints_3d": np.concatenate(
                        [rng.uniform(8, SIZE - 8, (K, 2)), np.zeros((K, 1))],
                        axis=1).astype(np.float32),
                    "joints_3d_visible": np.ones((K, 3), np.float32),
                    "bbox": np.array([0, 0, SIZE, SIZE], np.float32),
                    "image": rng.integers(0, 256, (SIZE, SIZE, 3),
                                          dtype=np.uint8)}

        self.db, self.paired_samples, self.groups = [], [], []
        for _ in range(groups):
            sids = []
            for _ in range(shots):
                self.db.append(item())
                sids.append(len(self.db) - 1)
            rows = []
            for _ in range(queries):
                self.db.append(item())
                rows.append(len(self.paired_samples))
                self.paired_samples.append(sids + [len(self.db) - 1])
            self.groups.append((tuple(sids), rows))

    def __len__(self):
        return len(self.paired_samples)

    def support_groups(self):
        return self.groups

    def _support(self, sid_lists):
        img = np.stack([np.stack([self.db[s]["image"] for s in sids])
                        for sids in sid_lists])
        joints = np.stack([np.stack([self.db[s]["joints_3d"][:, :2]
                                     for s in sids]) for sids in sid_lists])
        return img, joints

    def _meta(self, rows):
        nq = len(rows)
        return {"query_image_file": [f"./q{r}.png" for r in rows],
                "query_center": np.full((nq, 2), SIZE / 2, np.float32),
                "query_scale": np.full((nq, 2), SIZE / 200.0, np.float32),
                "bbox_id": rows}

    def collate_group(self, chunk):
        g = len(chunk)
        rows = [r for _, rs in chunk for r in rs]
        img_s, joints_s = self._support([sids for sids, _ in chunk])
        support = {"img_s": img_s, "joints_s": joints_s,
                   "vis_s": np.ones((g, self.shots, K), np.float32),
                   "binary_adj": np.tile(self.adj, (g, 1, 1))}
        query = {"img_q": np.stack([self.db[self.paired_samples[r][-1]]
                                    ["image"] for r in rows]),
                 "group": np.repeat(np.arange(g, dtype=np.int32),
                                    self.queries)}
        return support, query, self._meta(rows)

    def batches(self, batch_size, masking_ratio=0.0):
        """One episode per row, as the uncached loop takes them:
        normalised float images and rendered support heatmaps."""
        from edgecape_tpu_torch.api import IMAGENET_MEAN, IMAGENET_STD
        from edgecape_tpu_torch.ops import heatmap

        def norm(img):
            return ((img.astype(np.float32) / 255.0 - IMAGENET_MEAN)
                    / IMAGENET_STD).astype(np.float32)

        for i in range(0, len(self.paired_samples), batch_size):
            rows = list(range(i, min(i + batch_size,
                                     len(self.paired_samples))))
            pairs = [self.paired_samples[r] for r in rows]
            img_s, joints_s = self._support([p[:-1] for p in pairs])
            vis = torch.ones((len(rows), self.shots, K))
            target, weight = heatmap.render_msra(
                torch.from_numpy(joints_s), vis, (64, 64),
                (float(SIZE), float(SIZE)), 1.0)
            yield types.SimpleNamespace(
                img_s=norm(img_s),
                img_q=norm(np.stack([self.db[p[-1]]["image"]
                                     for p in pairs])),
                target_s=target.numpy(), weight_s=weight[..., 0].numpy(),
                binary_adj=np.tile(self.adj, (len(rows), 1, 1)),
                meta=self._meta(rows))


def loss_without_dropout(trainer, batch):
    """The training loss of `batch` with every dropout rate set to 0
    (training mode, no gradient)."""
    from edgecape_tpu_torch.train.loop import batch_to_tensors, make_loss_fn
    rated = [m for m in trainer.model.modules() if hasattr(m, "dropout")]
    rates = [m.dropout for m in rated]
    for m in rated:
        m.dropout = 0.0
    try:
        trainer.model.train()
        with torch.no_grad():
            total, _ = make_loss_fn(trainer.model, trainer.backbone,
                                    trainer.cfg)(
                batch_to_tensors(batch, trainer.device))
    finally:
        for m, r in zip(rated, rates):
            m.dropout = r
    return float(total)


def train_path(dev, entries, power):
    from edgecape_tpu_torch import config as C
    from edgecape_tpu_torch.models.convert import (init_params,
                                                   redraw_zero_inits)
    from edgecape_tpu_torch.train import checkpoint as ck
    from edgecape_tpu_torch.train.loop import (Trainer, batch_to_tensors,
                                               make_loss_fn)
    from edgecape_tpu_torch.train.state import frozen_roots
    import edgecape_tpu_torch.ops.flash_attention as FA
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    import edgecape_tpu_torch.ops.fused_vit_block as FV

    def reset():
        FA.launches_fwd = FA.launches_bwd = FA.launches = 0
        FV.launches = FE.launches = FE.stack_launches = FD.launches = 0

    def expected(cfg, steps):
        """flash_mha_train launches of `steps` steps: one forward per
        refine, encoder and decoder layer, the decoder's twice with the
        reconstruction branch; one backward for each of them whose inputs
        need a gradient (not the refine layers of a frozen skeleton)."""
        m = cfg.model
        refine = m.skeleton_num_layers if m.learn_skeleton else 0
        dec = m.num_decoder_layers * (2 if m.masked_supervision else 1)
        fwd = refine + m.num_encoder_layers + dec
        bwd = fwd - (refine if "skeleton" in frozen_roots(m.model_freeze)
                     else 0)
        return {"flash_mha_train_fwd": steps * fwd,
                "flash_mha_train_bwd": steps * bwd,
                "fused_vit_block": steps * 12}

    def counts():
        return {"flash_mha_train_fwd": FA.launches_fwd,
                "flash_mha_train_bwd": FA.launches_bwd,
                "fused_vit_block": FV.launches}

    with tempfile.TemporaryDirectory() as tmp:
        base = train_config(tmp)
        stage3 = C.replace(C.stage3_config(base), work_dir=tmp + "/bias")
        gen = torch.Generator().manual_seed(SEED)
        bb, head = init_params(gen, stage3.model)
        redraw_zero_inits(bb, head, gen)
        ck.save_checkpoint(tmp + "/seeded", {"model": head})
        stage3.load_from = tmp + "/seeded"
        data = RefedBatch(TRAIN_STEPS, np.random.default_rng(SEED + 2))

        # --- stage 3 through the trainer's own fit()
        lines, stamps = [], []

        def log(msg):
            lines.append(msg)
            stamps.append(time.perf_counter())

        tr = Trainer(stage3, data, lambda ds, bs, **kw: ds,
                     backbone_state=bb, device=dev, log_fn=log)
        if not tr.cfg.model.use_flash:
            fail("the trainer did not select the kernel path")
        before = {n: p.detach().clone()
                  for n, p in tr.model.named_parameters()}
        for n, p in tr.model.named_parameters():
            if not torch.equal(p.detach().cpu(), head[n]):
                fail(f"warm start did not load {n}")
        loss0 = loss_without_dropout(tr, data.batch)
        reset()
        tr.fit()
        torch.cuda.synchronize()
        got, want = counts(), expected(stage3, TRAIN_STEPS)
        other = {"fused_encoder_stack": FE.stack_launches,
                 "fused_decoder_layer": FD.launches, "flash_mha": FA.launches}
        print(f"[train] stage 3, {TRAIN_STEPS} steps of batch {TRAIN_B}: "
              f"launches {got} expected {want}; eval-only ops {other}",
              flush=True)
        if got != want or any(other.values()):
            fail("training launch counts differ from what the path implies")
        for name in ("flash_mha_train_fwd", "flash_mha_train_bwd"):
            entries[name]["launches"] = got[name]
        for line in (ln for ln in lines if " it " in ln):
            print("[train] " + line, flush=True)
            vals = [float(t.split("=")[1]) for t in line.split() if "=" in t]
            if not vals or not np.isfinite(vals).all():
                fail("a training metric is not finite")
        if tr.step != TRAIN_STEPS or not ck.latest_checkpoint(stage3.work_dir):
            fail("fit did not run its steps or wrote no checkpoint")
        loss1 = loss_without_dropout(tr, data.batch)
        print(f"[train] re-fed batch, loss without dropout: {loss0:.6f} "
              f"before, {loss1:.6f} after {TRAIN_STEPS} steps", flush=True)
        if not (np.isfinite([loss0, loss1]).all() and loss1 < loss0):
            fail("the loss on the re-fed batch did not fall")
        roots = frozen_roots(stage3.model.model_freeze)
        moved = still = 0
        for n, p in tr.model.named_parameters():
            same = torch.equal(p, before[n])
            if n.split(".")[0] in roots:
                if not same or p.requires_grad:
                    fail(f"frozen parameter {n} changed")
                still += 1
            else:
                moved += int(not same)
        n_train = len(before) - still
        print(f"[train] {still} frozen parameters bit-unchanged, {moved} of "
              f"{n_train} trainable ones moved", flush=True)
        if moved < 0.9 * n_train:
            fail("trainable parameters did not move")
        step_ms = np.diff(stamps[-(TRAIN_STEPS - 1):]) * 1e3
        print(f"[train] kernel path: median {np.median(step_ms):.3f} ms/step "
              f"over {len(step_ms)} steps after warm-up on {power} "
              f"(information only)", flush=True)

        # --- one step's gradients: kernel path against the plain path
        grads = {}
        for flash in (True, False):
            cfg = C.replace(stage3, work_dir=tmp + "/grads", model=C.replace(
                stage3.model, use_flash=flash, dropout=0.0))
            t2 = Trainer(cfg, data, lambda ds, bs, **kw: ds,
                         backbone_state=bb, device=dev,
                         log_fn=lambda *a: None)
            total, _ = make_loss_fn(t2.model, t2.backbone, cfg)(
                batch_to_tensors(data.batch, dev))
            total.backward()
            grads[flash] = {n: p.grad.float() for n, p in
                            t2.model.named_parameters()
                            if p.grad is not None}
            if not flash:
                plain_trainer = t2
        rel_l2, worst, worst_name, _ = grad_gap(grads[True], grads[False])
        ok = rel_l2 <= GRAD_REL_L2 and worst <= GRAD_TENSOR_REL_L2
        print(f"[train] one step's gradients, kernel path vs plain path "
              f"(dropout 0): relative L2 over all {rel_l2:.4g} (tol "
              f"{GRAD_REL_L2}), worst tensor {worst:.4g} {worst_name} (tol "
              f"{GRAD_TENSOR_REL_L2}) {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("kernel-path gradients disagree with the plain path")

        # --- the plain path's step time (no kernels in the head)
        def timed_steps(trainer, n):
            out = []
            for _ in range(n):
                t0 = time.perf_counter()
                trainer.train_step(data.batch)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return out

        plain_ms = timed_steps(plain_trainer, SIDE_STEPS + 1)[1:]
        print(f"[train] plain path (use_flash=False): median "
              f"{np.median(plain_ms):.3f} ms/step over {len(plain_ms)} steps "
              f"after warm-up on {power} (information only)", flush=True)

        # --- stage 2: the unfrozen skeleton's unbiased attention backward
        # and the trainer's eval hook on a small in-memory validation set
        # (the estimator's fp32 compute mode through the eval kernels)
        stage2 = C.replace(C.stage2_config(base), work_dir=tmp + "/skeleton",
                           load_from=tmp + "/seeded")
        stage2.train = C.replace(stage2.train, eval_interval=1)
        data2 = RefedBatch(2, np.random.default_rng(SEED + 3))
        val = EvalEpisodes(np.random.default_rng(SEED + 4))
        lines2 = []
        tr2 = Trainer(stage2, data2, lambda ds, bs, **kw: ds, val_ds=val,
                      backbone_state=bb, device=dev, log_fn=lines2.append)
        reset()
        tr2.fit()
        torch.cuda.synchronize()
        got, want = counts(), expected(stage2, 2)
        # the eval hook's trunk is the fp32 module (its attention through
        # flash_mha), so it should add no fused_vit_block launch
        vit_eval = got.pop("fused_vit_block") - want.pop("fused_vit_block")
        print(f"[train] stage 2, 2 steps: launches {got} expected {want}; "
              f"eval hook: {vit_eval} fused_vit_block, {FE.stack_launches} "
              f"fused_encoder_stack, {FD.launches} fused_decoder_layer, "
              f"{FA.launches} flash_mha launches", flush=True)
        if got != want:
            fail("stage-2 launch counts differ from what the path implies")
        print("[train] " + next(ln for ln in lines2 if "val PCK" in ln),
              flush=True)
        if not (0.0 <= tr2.best_pck <= 1.0) or \
                not ck.best_checkpoint(stage2.work_dir).endswith(
                    "best_PCK_epoch_1"):
            fail("the eval hook gave no PCK or kept no best checkpoint")
        if min(FE.stack_launches, FD.launches, FA.launches) <= 0:
            fail("the eval hook did not run through the eval kernels")
        for line in (ln for ln in lines2 if " it " in ln):
            print("[train] " + line, flush=True)
            vals = [float(t.split("=")[1]) for t in line.split() if "=" in t]
            if not vals or not np.isfinite(vals).all():
                fail("a stage-2 training metric is not finite")
        zc = tr2.model.skeleton.zero_conv_w
        if zc.grad is None or not torch.isfinite(zc.grad).all() \
                or zc.grad.abs().max().item() == 0:
            fail("the skeleton's zero-conv received no gradient in stage 2")

        profile(lambda: tr.train_step(data.batch),
                "one stage-3 training step of the kernel path", power)


# ------------------------------------------------------------ phase 5
def variant_op_checks(dev, entries, power):
    """fused_ln_mlp, fused_attn_block, fused_vit_block2 and
    fused_decoder_stack against their plain versions at the eval chunk's
    shapes; one call of the stack under the profiler."""
    import edgecape_tpu_torch.ops.fused_attn_block as FB
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_mlp as FM
    import edgecape_tpu_torch.ops.fused_vit_block as FV
    from edgecape_tpu_torch.models.dinov2 import VIT_S14, Block
    from edgecape_tpu_torch.models.transformer import (Decoder,
                                                       ensure_some_valid,
                                                       inverse_sigmoid)
    from edgecape_tpu_torch.ops import kernels as KN
    from edgecape_tpu_torch.tools import bench_attention as BA

    g, rn = seeded_randn(SEED + 5, dev)
    bf = torch.bfloat16
    bad = []
    nq, n_tok, c_vit = GROUPS * QUERIES, 257, 384
    with torch.no_grad():
        blk_a, blk_b = (randomize(Block(VIT_S14), rn, dev)
                        for _ in range(2))
        x = rn(nq, n_tok, c_vit).to(bf)
        at = blk_a.attn
        wqkv = at.qkv.weight.t().contiguous()                  # [C, 3C]
        attn_args = (blk_a.norm1.weight, blk_a.norm1.bias,
                     wqkv[:, :c_vit].contiguous(), at.qkv.bias[:c_vit],
                     wqkv[:, c_vit:2 * c_vit].contiguous(),
                     at.qkv.bias[c_vit:2 * c_vit],
                     wqkv[:, 2 * c_vit:].contiguous(),
                     at.qkv.bias[2 * c_vit:],
                     at.proj.weight.t().contiguous(), at.proj.bias, blk_a.ls1)
        mlp_args = (blk_a.norm2.weight, blk_a.norm2.bias,
                    blk_a.mlp_fc1.weight.t().contiguous(), blk_a.mlp_fc1.bias,
                    blk_a.mlp_fc2.weight.t().contiguous(), blk_a.mlp_fc2.bias,
                    blk_a.ls2)
        xb = 2 * nbytes(x)
        # one vit_mlp_kernel a call, no GEMM
        mlp_call = lambda: FM.fused_ln_mlp(x, *mlp_args)  # noqa: E731
        mlp_out = mlp_call()
        extra, dev_ms, per_call, _ = device_extra(
            "fused_ln_mlp", mlp_call, 1, bad, ("vit_mlp_kernel",))
        check_op(entries, bad, "fused_ln_mlp",
                 "edgecape_tpu/ops/fused_mlp.py:67",
                 "edgecape_tpu_torch/ops/fused_mlp.py", mlp_out,
                 FM.fused_ln_mlp_plain(x, *mlp_args), mlp_call,
                 lambda: FM.fused_ln_mlp_plain(x, *mlp_args),
                 bound(xb + nbytes(*mlp_args),
                       2 * nq * n_tok * 8 * c_vit ** 2),
                 counter=(FM, "launches"), copy_gemms=0, tma_gemms=0,
                 extra=extra)
        entries["fused_ln_mlp"].update(device_ms=dev_ms,
                                       kernels_per_call=per_call)
        # vit_mlp_kernel at every shape the paths give it, beside the chain
        # of three launches it replaced (tools/bench_vit_mlp.py)
        from edgecape_tpu_torch.tools import bench_vit_mlp as BVM
        rows = [BVM.run_case(spec, dev, power) for spec in BVM.SHAPES]
        bad += [f"vit_mlp {r['shape']}" for r in rows if not r["ok"]]
        entries["fused_ln_mlp"]["vit_mlp_shapes"] = rows
        # two kernels a call (vit_qkv_kernel, vit_attn_kernel), no GEMM
        attn_call = lambda: FB.fused_attn_block(  # noqa: E731
            x, *attn_args, num_heads=6)
        attn_out = attn_call()
        extra, dev_ms, per_call, _ = device_extra(
            "fused_attn_block", attn_call, 2, bad, VIT_KERNELS[:2])
        check_op(entries, bad, "fused_attn_block",
                 "edgecape_tpu/ops/fused_attn_block.py:100",
                 "edgecape_tpu_torch/ops/fused_attn_block.py", attn_out,
                 FB.fused_attn_block_plain(x, *attn_args, num_heads=6),
                 attn_call,
                 lambda: FB.fused_attn_block_plain(x, *attn_args, num_heads=6),
                 bound(xb + nbytes(*attn_args),
                       2 * nq * n_tok * 4 * c_vit ** 2
                       + 4 * nq * n_tok ** 2 * c_vit),
                 counter=(FB, "launches"), copy_gemms=0, tma_gemms=0,
                 extra=extra)
        entries["fused_attn_block"].update(device_ms=dev_ms,
                                           kernels_per_call=per_call)
        # vit_qkv_kernel and vit_attn_kernel at every shape the paths give
        # them, beside the four launches they replaced
        # (tools/bench_vit_attn.py)
        from edgecape_tpu_torch.tools import bench_vit_attn as BVA
        rows = [BVA.run_case(spec, dev, power) for spec in BVA.SHAPES]
        bad += [f"vit_attn {r['shape']}" for r in rows if not r["ok"]]
        entries["fused_attn_block"]["vit_attn_shapes"] = rows

        # fused_vit_block2: bit-equal to two calls of fused_vit_block for
        # bf16 and for fp32 input; each block against the plain block on
        # the kernel's own input (a one-ulp difference is amplified by the
        # next block, as in the encoder stack)
        for xin in (x, x.float()):
            one = FV.fused_vit_block(xin, blk_a, num_heads=6, eps=1e-6)
            two = FV.fused_vit_block(one, blk_b, num_heads=6, eps=1e-6)
            pair = FV.fused_vit_block2(xin, blk_a, blk_b, num_heads=6,
                                       eps=1e-6)
            same = torch.equal(pair, two) and pair.dtype == xin.dtype
            print(f"[op] fused_vit_block2 on {xin.dtype}: bit-equal to two "
                  f"fused_vit_block calls: {same}", flush=True)
            if not same:
                bad.append(f"fused_vit_block2 bit-equality on {xin.dtype}")
            if xin is x:
                outs = torch.stack([one, two])
                refs = torch.stack([
                    FV.fused_vit_block_plain(x, blk_a, num_heads=6, eps=1e-6),
                    FV.fused_vit_block_plain(one, blk_b, num_heads=6,
                                             eps=1e-6)])
        one_ms = time_ms(lambda: FV.fused_vit_block(x, blk_a, num_heads=6,
                                                    eps=1e-6))
        # six kernels a call: per block vit_qkv_kernel, vit_attn_kernel
        # and vit_mlp_kernel (the first block's result stored as bf16)
        pair_call = lambda: FV.fused_vit_block2(  # noqa: E731
            x, blk_a, blk_b, num_heads=6, eps=1e-6)
        extra, dev_ms, per_call, _ = device_extra(
            "fused_vit_block2", pair_call, 6, bad, VIT_KERNELS)
        check_op(entries, bad, "fused_vit_block2",
                 "edgecape_tpu/ops/fused_vit_block.py:248",
                 "edgecape_tpu_torch/ops/fused_vit_block.py", outs, refs,
                 pair_call,
                 lambda: FV.fused_vit_block2_plain(x, blk_a, blk_b,
                                                   num_heads=6, eps=1e-6),
                 bound(xb + param_bytes(blk_a, blk_b),
                       2 * (2 * nq * n_tok * 12 * c_vit ** 2
                            + 4 * nq * n_tok ** 2 * c_vit)),
                 counter=(FV, "launches2"), copy_gemms=0, tma_gemms=0,
                 extra=f"; one fused_vit_block {one_ms:.3f} ms{extra}")
        entries["fused_vit_block2"].update(device_ms=dev_ms,
                                           kernels_per_call=per_call)

        # fused_decoder_stack at the chunk's decoder shape
        hw, c, heads, ffn, layers, nf, nhop = 256, 256, 8, 384, 3, 128, 5
        # in bf16 like the estimator's query head, whose bias MLP and glue
        # then run on bf16 parameters
        dec = randomize(Decoder(c, heads, ffn, layers, attn_bias=True,
                                max_hops=nhop - 1, num_feats=nf,
                                use_flash=True), rn, dev).to(bf)
        kx = rn(nq, K, c, s=0.5).to(bf)
        coords = torch.rand(nq, K, 2, generator=g).to(dev) * 0.8 + 0.1
        img, ipos = rn(nq, hw, c, s=0.5).to(bf), rn(hw, c, s=0.5).to(bf)
        kvalid = torch.rand(nq, K, generator=g).to(dev) > 0.3
        kvalid[:, 0] = True
        kvalid = ensure_some_valid(kvalid)
        hops = torch.rand(nq, K, K, nhop, generator=g).to(dev).to(bf)
        adj = (torch.rand(nq, 2, K, K, generator=g).to(dev) / K).to(bf)
        args = (kx, coords, img, ipos, kvalid, hops, adj)
        kw = dict(num_heads=heads, num_feats=nf)

        # the stack's own kernels at its shapes, on its first layer's
        # prepared weights
        sw = FD._build_stack_weights(dec, nf, True)
        lw0 = sw["layers"][0]
        qkv = rn(nq, K, 3 * c).to(bf)
        hid = nhop - 1 + heads
        check_op(entries, bad, "bias_attention",
                 "edgecape_tpu/ops/fused_decoder.py:531",
                 "edgecape_tpu_torch/ops/kernels.py",
                 KN.bias_attention(qkv, kvalid, hops, lw0["hop_mlp"],
                                   num_heads=heads),
                 FD.bias_attention_plain(qkv, kvalid, hops, lw0["hop_mlp"],
                                         num_heads=heads),
                 lambda: KN.bias_attention(qkv, kvalid, hops, lw0["hop_mlp"],
                                           num_heads=heads),
                 lambda: FD.bias_attention_plain(qkv, kvalid, hops,
                                                 lw0["hop_mlp"],
                                                 num_heads=heads),
                 bound(nbytes(qkv, kvalid, hops, *lw0["hop_mlp"])
                       + nq * K * c * 2, 4 * nq * heads * K * K * (c // heads),
                       2 * nq * K * K * (nhop * hid + hid * heads)),
                 copy_gemms=0,
                 extra=f"; [B {nq}, K {K}, H {heads}, D {c // heads}], "
                       f"n_hop {nhop}, hidden {hid}; plan "
                       f"{json.dumps(KN.bias_attention_plan(nq, K, heads, 32))}")
        r = nq * K
        xk = rn(r, c).to(bf)
        ctk = torch.rand(r, 2, generator=g).to(dev)
        pts_k, outs_k = torch.empty_like(ctk), torch.empty_like(ctk)

        def kpt_kernel():
            KN.kpt_head(xk, ctk, sw["fn"], lw0["kpt"], lw0["kow"],
                        lw0["kob"], pts_k, outs_k, eps=1e-5)
            return torch.stack([pts_k, outs_k])

        def kpt_plain():
            return torch.stack(FD.kpt_head_plain(
                xk, ctk, sw["fn"], lw0["kpt"], lw0["kow"], lw0["kob"],
                eps=1e-5))

        got, want = kpt_kernel().clone(), kpt_plain()
        dk = (got - want).abs()
        kpt_ok = dk.max().item() <= KPT_MAX and dk.mean().item() <= KPT_MEAN
        check_op(entries, bad, "kpt_head",
                 "edgecape_tpu/ops/fused_decoder.py:531",
                 "edgecape_tpu_torch/ops/kernels.py", got, want, kpt_kernel,
                 kpt_plain,
                 bound(nbytes(xk, ctk, pts_k, outs_k, *sw["fn"], lw0["kow"],
                              lw0["kob"], *(t for pair in lw0["kpt"]
                                            for t in pair)),
                       2 * 2 * r * (3 * c * c + 2 * c)),
                 copy_gemms=0,
                 extra=f"; [R {r}, C {c}] pts and outs; coordinates max "
                       f"{dk.max().item():.3g} mean {dk.mean().item():.3g} "
                       f"(tol {KPT_MAX}, mean {KPT_MEAN}) "
                       f"{'OK' if kpt_ok else 'FAIL'}")
        if not kpt_ok:
            bad.append("kpt_head coordinates")
        del qkv, xk, ctk, pts_k, outs_k, got, want, dk
        worst = 0.0
        for i in range(layers):
            sub = Decoder(c, heads, ffn, 1, attn_bias=True, max_hops=nhop - 1,
                          num_feats=nf)
            sub.layers[0], sub.kpt_branches[0] = dec.layers[i], \
                dec.kpt_branches[i]
            sub.ref_point_head, sub.norm = dec.ref_point_head, dec.norm
            sub.to(dev).eval()
            o, p_ = FD.fused_decoder_stack(*args, sub, **kw)
            ro, rp = FD.fused_decoder_stack_plain(*args, sub, **kw)
            torch.cuda.synchronize()
            d = torch.cat([(o - ro).abs().flatten(),
                           (p_ - rp).abs().flatten()])
            ok = d.max().item() <= STACK_LAYER_MAX and \
                d.mean().item() <= STACK_LAYER_MEAN and \
                bool(torch.isfinite(o).all() and torch.isfinite(p_).all())
            worst = max(worst, d.max().item())
            print(f"[op] fused_decoder_stack layer {i} alone, outputs and "
                  f"points {tuple(o.shape)}: max_abs_err {d.max().item():.4g} "
                  f"mean_abs_err {d.mean().item():.3g} (tol "
                  f"{STACK_LAYER_MAX}, mean {STACK_LAYER_MEAN}) "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append(f"fused_decoder_stack layer {i}")

        def chain():
            """The layer chain: fused_decoder_layer per layer, the glue and
            the head recompute in PyTorch."""
            inter, points = dec(kx, img, kp_valid=kvalid,
                                img_pos=ipos[None].expand(nq, -1, -1),
                                initial_proposals=coords, adj=adj,
                                hop_stack=hops)
            return torch.stack([
                torch.sigmoid(dec.kpt_branches[i](inter[i]).float()
                              + inverse_sigmoid(points[i]))
                for i in range(layers)])

        n0 = FD.launches
        ref_chain = chain()
        if FD.launches - n0 != layers:
            fail("the layer chain did not run fused_decoder_layer")
        n0 = FD.stack_launches
        stack_out, _ = FD.fused_decoder_stack(*args, dec, **kw)
        one_call = FD.stack_launches - n0
        torch.cuda.synchronize()
        d = (stack_out - ref_chain.float()).abs()[:, kvalid]
        med = d.median().item()
        p95 = float(np.quantile(d.cpu().numpy(), 0.95))
        ok = 0 < d.max().item() and med <= STACK_CHAIN_MEDIAN \
            and p95 <= STACK_CHAIN_P95
        print(f"[op] fused_decoder_stack vs the chain of fused_decoder_layer "
              f"(valid keypoints): median {med:.4g} (tol "
              f"{STACK_CHAIN_MEDIAN}), 95th percentile {p95:.4g} (tol "
              f"{STACK_CHAIN_P95}), max {d.max().item():.4g} (must be > 0) "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append("fused_decoder_stack vs the layer chain")
        chain_ms = time_ms(chain)
        r = nq * K
        layer_flops = (
            2 * r * 4 * c ** 2 + 4 * nq * K * K * c
            + 2 * r * (4 + 4 + 2) * c ** 2 + 2 * nq * hw * (2 + 2) * c ** 2
            + 4 * nq * K * hw * 2 * c + 2 * r * (2 * c * ffn + ffn * c)
            + 2 * nq * 2 * K * K * ffn)
        glue_flops = 2 * r * (4 * nf * c + c * c) \
            + 2 * 2 * r * (3 * c * c + 2 * c)
        hid = nhop - 1 + heads
        bias_flops = 2 * nq * K * K * (nhop * hid + hid * heads)
        outs_bytes = 2 * layers * r * 2 * 4
        whole = FD.fused_decoder_stack(*args, dec, **kw)
        whole_ref = FD.fused_decoder_stack_plain(*args, dec, **kw)
        err = max((a - b).abs().max().item()
                  for a, b in zip(whole, whole_ref))
        ms = time_ms(lambda: FD.fused_decoder_stack(*args, dec, **kw))
        plain_ms = time_ms(lambda: FD.fused_decoder_stack_plain(*args, dec,
                                                                **kw), reps=3)
        bnd = bound(nbytes(*args) + param_bytes(dec) + outs_bytes,
                    layers * (layer_flops + glue_flops), layers * bias_flops)
        # device time and kernels of one call (device_extra: the count
        # from the launch counters where the traces lost their events)
        stack_call = lambda: FD.fused_decoder_stack(*args, dec, **kw)  # noqa: E731
        copy_gemms = BA.launched(stack_call).get("gemm_kernel", 0)
        dev_text, dev_ms, per_call, by_name = device_extra(
            "fused_decoder_stack", stack_call, STACK_KERNELS, bad,
            ("bias_attn_kernel", "kpt_head_kernel", "dec_post_self_kernel",
             "dec_post_cross_kernel"))
        print(f"[op] fused_decoder_stack: {layers} layers, rows {nq}, K {K}, "
              f"HW {hw}, C {c}, Markov bias from the hop stack, formed once "
              f"for all heads: {one_call} launch count per call, whole stack "
              f"vs plain max_abs_err {err:.4g} (information: ulp differences "
              f"grow through the layers; the bound is on each layer alone, "
              f"worst {worst:.4g}, tol {STACK_LAYER_MAX}) kernel {ms:.3f} ms "
              f"plain {plain_ms:.3f} ms chain of fused_decoder_layer with "
              f"PyTorch glue {chain_ms:.3f} ms bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) library none; {copy_gemms} thread-copy GEMMs a "
              f"call{dev_text}", flush=True)
        if copy_gemms or any("gemm_kernel<" in k or "attn_kernel<32, 5" in k
                             for k in by_name):
            bad.append("fused_decoder_stack: a thread-copy GEMM or the old "
                       "hop-stack attention ran")
        entries["fused_decoder_stack"] = {
            "name": "fused_decoder_stack", "route": "cuda",
            "source": "edgecape_tpu_torch/csrc/kernels.cu",
            "op": "edgecape_tpu_torch/ops/fused_decoder.py",
            "replaces": "edgecape_tpu/ops/fused_decoder.py:531",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "chain_ms": chain_ms, "device_ms": dev_ms,
            "kernels_per_call": per_call}
        if not bad:
            profile(lambda: FD.fused_decoder_stack(*args, dec, **kw),
                    "one fused_decoder_stack call at the chunk's shape",
                    power, rows=14)
    if bad:
        fail(f"variant ops disagree with their plain versions: {bad}")


# ------------------------------------------------------------ phase 6
def variant_path(dev, entries, power, est, data, default_preds, tuned_out):
    """forward_cached with the decoder_stack and vit_pair_blocks switches:
    launch counts, agreement with the default path, and the A/B ratios."""
    from edgecape_tpu_torch.eval.runner import run_cached
    from edgecape_tpu_torch.ops import kernel_config as KC
    from edgecape_tpu_torch.ops import kernels as KN
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_vit_block as FV

    nq = GROUPS * QUERIES
    chunks = [(i, GROUPS) for i in range(CHUNKS)]

    def run(stack, pair):
        KC.set_decoder_stack(stack)
        KC.set_vit_pair_blocks(pair)
        preds = []
        FV.launches = FV.launches2 = FD.launches = FD.stack_launches = 0
        KN.launches.update(dict.fromkeys(KN.launches, 0))
        t0 = time.perf_counter()
        run_cached(est, chunks, lambda i: data[i],
                   lambda pred, *a: preds.append(pred))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fused_vit_block": FV.launches,
                  "fused_vit_block2": FV.launches2,
                  "fused_decoder_layer": FD.launches,
                  "fused_decoder_stack": FD.stack_launches,
                  **{k: KN.launches[k] for k in VARIANT_KERNELS}}
        return preds, wall, counts

    try:
        run(True, True)                      # warm-up of the variant ops
        preds, wall, counts = run(True, True)
        expect = {"fused_vit_block": 0, "fused_vit_block2": 12 * CHUNKS,
                  "fused_decoder_layer": 0, "fused_decoder_stack": CHUNKS,
                  "bias_attn_kernel": 3 * CHUNKS,
                  "kpt_head_kernel": 3 * CHUNKS,
                  "vit_mlp_kernel": 24 * CHUNKS,
                  "vit_qkv_kernel": 24 * CHUNKS,
                  "vit_attn_kernel": 24 * CHUNKS}
        print(f"[variant] both switches on: launches {counts} expected "
              f"{expect} ({CHUNKS} chunks: per chunk 12 fused_vit_block2 "
              f"over the two backbone passes, each with two launches of "
              f"each ViT kernel, and 1 fused_decoder_stack, whose 3 layers "
              f"launch the bias attention and the keypoint head once each)",
              flush=True)
        if counts != expect:
            fail("variant path launch counts differ from what it implies")
        for name, key in (("fused_vit_block2",) * 2,
                          ("fused_decoder_stack",) * 2,
                          ("bias_attention", "bias_attn_kernel"),
                          ("kpt_head", "kpt_head_kernel")):
            entries[name]["launches"] = counts[key]
        d = np.abs(np.stack(preds) - np.stack(default_preds))
        ok = np.isfinite(np.stack(preds)).all() and d.max() > 0 \
            and np.median(d) <= STACK_CHAIN_MEDIAN \
            and np.quantile(d, 0.95) <= STACK_CHAIN_P95
        print(f"[variant] predictions vs the default path: median "
              f"{np.median(d):.4g} (tol {STACK_CHAIN_MEDIAN}), 95th "
              f"percentile {np.quantile(d, 0.95):.4g} (tol {STACK_CHAIN_P95})"
              f", max {d.max():.4g} (must be > 0) {'OK' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("variant path disagrees with the default path")
        # the pair switch alone must not change a bit
        p_pair, _, _ = run(False, True)
        if not np.array_equal(np.stack(p_pair), np.stack(default_preds)):
            fail("vit_pair_blocks changed the predictions")

        # A/B in turns: default, both, pair, stack, three times over; best
        # wall of each
        walls = {"default": [], "both": [], "vit_pair_blocks": [],
                 "decoder_stack": []}
        for _ in range(3):
            for name, (stack, pair) in (("default", (False, False)),
                                        ("both", (True, True)),
                                        ("vit_pair_blocks", (False, True)),
                                        ("decoder_stack", (True, False))):
                walls[name].append(run(stack, pair)[1])
        best = {k: min(v) for k, v in walls.items()}
        rate = {k: CHUNKS * nq / v for k, v in best.items()}
        ratios = {k: best["default"] / best[k]
                  for k in ("both", "vit_pair_blocks", "decoder_stack")}
        print(f"[variant] {CHUNKS} chunks x {nq} queries, best of 3 in turns "
              f"on {power}: default {rate['default']:.1f} img/s, both "
              f"switches {rate['both']:.1f} img/s, vit_pair_blocks alone "
              f"{rate['vit_pair_blocks']:.1f} img/s, decoder_stack alone "
              f"{rate['decoder_stack']:.1f} img/s; A/B ratio (default time / "
              f"variant time) both {ratios['both']:.4f}, vit_pair_blocks "
              f"{ratios['vit_pair_blocks']:.4f}, decoder_stack "
              f"{ratios['decoder_stack']:.4f} (a switch is on above "
              f"{KC.THRESHOLD}; information only)", flush=True)
        if tuned_out:
            tuned = {"card": power, "threshold": KC.THRESHOLD,
                     "measured_by": "chip_smoke.py --write-tuned",
                     "shape": f"{CHUNKS} chunks of {GROUPS} groups x "
                              f"{QUERIES} queries, K={K}, {SIZE} px, bf16",
                     "img_per_s": rate,
                     "ab_ratios": {k: ratios[k] for k in
                                   ("vit_pair_blocks", "decoder_stack")},
                     "switches": {k: bool(ratios[k] > KC.THRESHOLD) for k in
                                  ("vit_pair_blocks", "decoder_stack")}}
            with open(tuned_out, "w") as f:
                json.dump(tuned, f, indent=1)
                f.write("\n")
            print(f"[variant] wrote {tuned_out}", flush=True)
    finally:
        KC.set_decoder_stack(False)
        KC.set_vit_pair_blocks(False)


# ------------------------------------------------------------ phase 7
def uncached_path(dev, power, est, weights):
    """run_eval(cache_supports=False) through the kernels, 1-shot and
    5-shot, against the cached loop on the same episodes; forward_debug;
    strict fp32 on the card against the CPU."""
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.eval.runner import run_eval
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    import edgecape_tpu_torch.ops.fused_vit_block as FV
    import edgecape_tpu_torch.ops.flash_attention as FA

    def kp(path):
        with open(path + "/result_keypoints.json") as f:
            return np.array([r["keypoints"] for r in json.load(f)])[..., :2]

    for shots in (1, 5):
        ds = EvalEpisodes(np.random.default_rng(SEED + 10 + shots),
                          groups=EVAL_GROUPS, queries=EVAL_QUERIES,
                          shots=shots)
        with tempfile.TemporaryDirectory() as tmp:
            FV.launches = FE.stack_launches = FD.launches = FA.launches = 0
            res = run_eval(ds, est, batch_size=EVAL_BATCH,
                           res_folder=tmp + "/u", progress=False)
            torch.cuda.synchronize()
            counts = {"fused_vit_block": FV.launches,
                      "fused_encoder_stack": FE.stack_launches,
                      "fused_decoder_layer": FD.launches,
                      "flash_mha": FA.launches}
            n_batches = -(-len(ds) // EVAL_BATCH)
            expect = {"fused_vit_block": 12 * n_batches,
                      "fused_encoder_stack": n_batches,
                      "fused_decoder_layer": 3 * n_batches,
                      "flash_mha": 3 * n_batches}
            cres = run_eval(ds, est, batch_size=EVAL_BATCH,
                            res_folder=tmp + "/c", progress=False,
                            cache_supports=True)
            pu, pc = kp(tmp + "/u"), kp(tmp + "/c")
        d = np.abs(pu - pc) / SIZE
        med, within = float(np.median(d)), float(np.mean(d <= PATH_CELL))
        ok = counts == expect and pu.shape == (len(ds), K, 2) \
            and np.isfinite(pu).all() and pu.min() >= -1e-3 \
            and pu.max() <= SIZE + 1e-3 \
            and all(np.isfinite(res[k]) for k in ("PCK", "NME", "AUC", "EPE")) \
            and med <= PATH_MEDIAN_TOL and within >= PATH_WITHIN_SHARE
        print(f"[uncached] {shots}-shot, {len(ds)} episodes in {n_batches} "
              f"batches through the kernels: launches {counts} expected "
              f"{expect}; PCK {res['PCK']:.4f} NME {res['NME']:.4f} (random "
              f"weights; cached loop: PCK {cres['PCK']:.4f}), "
              f"{res['images_per_sec']} img/s uncached, "
              f"{cres['images_per_sec']} img/s cached on {power} "
              f"(information only: {len(ds)} episodes); uncached vs cached "
              f"predictions: median {med:.4g} (tol {PATH_MEDIAN_TOL}), share "
              f"within {PATH_CELL:.4g}: {within:.4f} (tol >= "
              f"{PATH_WITHIN_SHARE}) {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"the uncached {shots}-shot path failed")

    # forward_debug on one batch: always the plain modules
    ds = EvalEpisodes(np.random.default_rng(SEED + 20), groups=2, queries=2)
    batch = next(ds.batches(4))
    n0 = (FV.launches, FE.stack_launches, FD.launches, FA.launches)
    pred, raw_adj, sim, attn = est.forward_debug(batch)
    torch.cuda.synchronize()
    ok = tuple(pred.shape) == (4, K, 2) and tuple(raw_adj.shape) == (4, K, K) \
        and tuple(sim.shape) == (4, K, 16, 16) \
        and tuple(attn.shape) == (3, 4, K, 256) \
        and all(bool(torch.isfinite(t.float()).all())
                for t in (pred, raw_adj, sim, attn)) \
        and bool(((attn.float().sum(-1) - 1).abs() < 1e-2).all()) \
        and n0 == (FV.launches, FE.stack_launches, FD.launches, FA.launches)
    print(f"[debug] forward_debug: pred {tuple(pred.shape)}, similarity "
          f"{tuple(sim.shape)}, attention maps {tuple(attn.shape)} (rows sum "
          f"to 1), finite, no kernel op launched: {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("forward_debug failed")

    # strict fp32: the same estimator on the card and on the CPU. TF32 is
    # switched on around the card's run; the estimator must switch it off.
    cfg = main_path_config()
    cfg.model.use_flash = False
    cfg.model.compute_dtype = cfg.model.head_dtype = "float32"
    bb, head = weights
    on_card = PoseEstimator(cfg, bb, head, device=dev)
    on_cpu = PoseEstimator(cfg, bb, head, device="cpu")
    if not on_card.strict:
        fail("the fp32 estimator did not select the strict path")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        pg, _, traj = on_card.forward_batch(batch)
        pg = pg.cpu().numpy()
        card_s = time.perf_counter() - t0
        kept = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
        # what the check would see if the estimator left TF32 on
        on_card.strict = False
        p_tf32 = on_card.forward_batch(batch)[0].cpu().numpy()
        on_card.strict = True
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    pc = on_cpu.forward_batch(batch)[0].numpy()
    d = np.abs(pg - pc)
    d_tf32 = np.abs(p_tf32 - pc)
    ok = kept and tuple(traj.shape) == (4, 4, K, 2) \
        and np.median(d) <= STRICT_MEDIAN \
        and np.quantile(d, 0.99) <= STRICT_P99
    print(f"[strict] fp32, use_flash=False, 4 one-shot episodes at full "
          f"width, card vs CPU: median {np.median(d):.3g} (tol "
          f"{STRICT_MEDIAN}), 99th percentile {np.quantile(d, 0.99):.3g} "
          f"(tol {STRICT_P99}), max {d.max():.3g} (with TF32 left on the "
          f"same comparison gives median {np.median(d_tf32):.3g}, 99th "
          f"percentile {np.quantile(d_tf32, 0.99):.3g}); first call on the card "
          f"{card_s:.3f} s; caller's TF32 settings restored: {kept} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("strict fp32 on the card disagrees with the CPU")


# ------------------------------------------------------------ phase 8
def bench_tool(entries, power):
    """The four chains of tools/bench_attn_variants at full width."""
    from edgecape_tpu_torch.tools import bench_attn_variants as BV
    import edgecape_tpu_torch.ops.fused_attn_block as FB
    import edgecape_tpu_torch.ops.fused_mlp as FM
    import edgecape_tpu_torch.ops.fused_vit_block as FV

    FB.launches = FM.launches = FV.launches = 0
    out = BV.main(["all"])
    runs = BV.LAYERS * (BV.ITERS + 1)
    counts = {"fused_attn_block": FB.launches, "fused_ln_mlp": FM.launches,
              "fused_vit_block": FV.launches}
    expect = {"fused_attn_block": 2 * runs, "fused_ln_mlp": 2 * runs,
              "fused_vit_block": runs}
    print(f"[bench] launches {counts} expected {expect}; both / block "
          f"{out['both'] / out['block']:.4f} on {power}", flush=True)
    if counts != expect or not all(np.isfinite(v) and v > 0
                                   for v in out.values()):
        fail("the bench tool's chains did not run as they should")
    entries["fused_attn_block"]["launches"] = counts["fused_attn_block"]
    entries["fused_ln_mlp"]["launches"] = counts["fused_ln_mlp"]


# ------------------------------------------------------------ phase 9
def cublas_chain(x, w1, w2, reps):
    """The chain as 2 x reps cuBLAS calls on bf16 (a yardstick the port
    never calls): h = x @ w1, then x = addmm(x, h, w2), whose epilogue adds
    x in fp32 and rounds once, the chain's own rounding points."""
    rows = x.reshape(-1, x.shape[-1])
    for _ in range(reps):
        rows = torch.addmm(rows, torch.mm(rows, w1), w2)
    return rows.view(x.shape)


def mm_chain_checks(dev, entries, power):
    """ops.mm_chain against mm_chain_plain at a small shape and the probe
    tool's three cases, `loop` and `fold`; beside the times the share of
    useful rows in each cut's tiles (ops/kernels.py mm_chain_plan), the
    share of the bound, the cuBLAS chain on the same inputs, and ptxas's
    registers and spills of the kernel."""
    import edgecape_tpu_torch.ops.mm_chain as MC
    from edgecape_tpu_torch.ops import kernels as KN
    from edgecape_tpu_torch.tools import probe_m_fold as P

    regs = "; ".join(
        f"C {64 * int(name.split('ILi')[1].split('E')[0])}: {r} registers, "
        f"{st} / {ld} bytes spilled (stores / loads)"
        for name, r, st, ld in KN.ptxas_usage("mm_chain_kernel")) or \
        "not built in this process"
    print(f"[op] mm_chain ptxas: {regs}", flush=True)
    bad = []
    for ci, (label, b, g, n, c, f, reps) in enumerate([MM_SMALL] + P.CASES):
        x, w1, w2 = P.inputs(b, n, c, f, dev)
        n0 = MC.launches
        outs = {fold: MC.mm_chain(x, w1, w2, reps, g, fold)
                for fold in (False, True)}
        counted = MC.launches - n0
        torch.cuda.synchronize()
        ref = MC.mm_chain_plain(x, w1, w2, reps, g, True).float()
        bitsame = torch.equal(outs[False], outs[True])
        d = (outs[True].float() - ref).abs()
        err, mean = d.max().item(), d.mean().item()
        top, mean_mag = ref.abs().max().item(), ref.abs().mean().item()
        ok = (bitsame and counted == 2 and err <= MM_MAX_REL * top
              and mean <= MM_MEAN_REL * mean_mag
              and bool(torch.isfinite(outs[True].float()).all()))
        ms = {fold: time_ms(lambda: MC.mm_chain(x, w1, w2, reps, g, fold))
              for fold in (False, True)}
        plain_ms = time_ms(lambda: MC.mm_chain_plain(x, w1, w2, reps, g,
                                                     True), reps=3, warmup=1)
        lib_ms = time_ms(lambda: cublas_chain(x, w1, w2, reps))
        lib_err = (cublas_chain(x, w1, w2, reps).float() - ref).abs().max()
        flops = 4.0 * b * n * c * f * reps
        bnd = bound(nbytes(x, x, w1, w2), flops)
        share = {fold: KN.mm_chain_plan(*((b // g, g * n) if fold else (b, n)),
                                        c, f)["useful_share"]
                 for fold in (False, True)}
        print(f"[op] mm_chain {label}: shape {tuple(ref.shape)} max_abs_err "
              f"{err:.4g} (tol {MM_MAX_REL:.4g} * max|ref| = "
              f"{MM_MAX_REL * top:.4g}) mean_abs_err {mean:.4g} (tol "
              f"{MM_MEAN_REL} * mean|ref| = {MM_MEAN_REL * mean_mag:.4g}) "
              f"loop == fold bit for bit: {bitsame}; kernel loop "
              f"{ms[False]:.3f} ms ({flops / ms[False] / 1e9:.1f} TFLOP/s, "
              f"{100 * bnd[0] / ms[False]:.1f}% of bound, useful rows "
              f"{100 * share[False]:.1f}% of its tiles) fold {ms[True]:.3f} "
              f"ms ({flops / ms[True] / 1e9:.1f} TFLOP/s, "
              f"{100 * bnd[0] / ms[True]:.1f}% of bound, useful rows "
              f"{100 * share[True]:.1f}%) plain {plain_ms:.3f} ms bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}) library none (one call); cuBLAS "
              f"chain of {2 * reps} calls {lib_ms:.3f} ms (max_abs_err "
              f"{lib_err.item():.4g} against plain, information); {counted} "
              f"launches counted for two calls on {power} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(label)
        if ci == 1:       # the table's row: the backbone case, g = 2, fold
            entries["mm_chain"] = {
                "name": "mm_chain", "route": "cuda",
                "source": "edgecape_tpu_torch/csrc/mm_chain.cu",
                "op": "edgecape_tpu_torch/ops/mm_chain.py",
                "replaces": "scripts/probe_m_fold.py:73", "launches": 0,
                "max_abs_err": err, "ms": ms[True], "loop_ms": ms[False],
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None, "cublas_chain_ms": lib_ms,
                "useful_share": {"loop": share[False], "fold": share[True]}}
    if bad:
        fail("mm_chain disagrees with its plain version: " + ", ".join(bad))


def probe_tool(entries, power):
    """python -m edgecape_tpu_torch.tools.probe_m_fold, as a user runs it."""
    import edgecape_tpu_torch.ops.mm_chain as MC
    from edgecape_tpu_torch.tools import probe_m_fold as P

    MC.launches = 0
    print("[probe] python -m edgecape_tpu_torch.tools.probe_m_fold", flush=True)
    results = P.main([])
    expect = len(P.CASES) * 2 * (1 + P.RUNS * P.ITERS)
    print(f"[probe] {len(results)} cases on {power}; mm_chain launches "
          f"{MC.launches} expected {expect}", flush=True)
    for r in results:
        print(f"[probe] {r['label']}: loop {r['loop_ms']:.3f} ms fold "
              f"{r['fold_ms']:.3f} ms ratio {r['speedup']:.4f} bitsame "
              f"{r['bitsame']}", flush=True)
    if len(results) != len(P.CASES) or MC.launches != expect or not all(
            r["bitsame"] and r["finite"] and r["loop_ms"] > 0
            and r["fold_ms"] > 0 for r in results):
        fail("the probe tool did not run as it should")
    entries["mm_chain"]["launches"] = MC.launches


# ----------------------------------------------------------- phase 10
DISK_CONFIG = """from edgecape_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                       TrainConfig, stage3_config)

_data = dict(ann_file={ann!r}, img_prefix={img!r}, num_shots=1,
             image_size={size}, heatmap_size=64, max_kpt={k}, sigma=1.0)
config = stage3_config(Config(
    model=ModelConfig(image_size={size}, max_kpt={k}, use_flash=True,
                      dropout={dropout}),
    train_data=DataConfig(**_data),
    val_data=DataConfig(),
    test_data=DataConfig(num_queries={queries}, num_episodes={episodes},
                         **_data),
    train=TrainConfig(total_epochs={epochs}, lr=1e-4, warmup_iters=2,
                      batch_size={batch}, eval_interval=1000,
                      ckpt_interval={epochs}, log_interval=1, seed={seed},
                      num_workers=4),
    work_dir={work!r}))
"""


def disk_path(dev, entries, power):
    """cli.train then cli.test on files on disk, at full width."""
    from edgecape_tpu_torch.cli import test as cli_test
    from edgecape_tpu_torch.cli import train as cli_train
    from edgecape_tpu_torch.data import synthetic
    from edgecape_tpu_torch.models.convert import (init_params,
                                                   redraw_zero_inits)
    from edgecape_tpu_torch.ops import kernel_config
    from edgecape_tpu_torch.utils.tb_writer import read_scalars
    import edgecape_tpu_torch.ops.flash_attention as FA
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    import edgecape_tpu_torch.ops.fused_vit_block as FV

    def reset():
        FA.launches_fwd = FA.launches_bwd = FA.launches = 0
        FV.launches = FV.launches2 = 0
        FE.launches = FE.stack_launches = 0
        FD.launches = FD.stack_launches = 0

    def counts():
        return {"fused_vit_block": FV.launches,
                "fused_vit_block2": FV.launches2,
                "fused_encoder_stack": FE.stack_launches,
                "fused_decoder_layer": FD.launches,
                "fused_decoder_stack": FD.stack_launches,
                "flash_mha": FA.launches,
                "flash_mha_train_fwd": FA.launches_fwd,
                "flash_mha_train_bwd": FA.launches_bwd}

    # the switches as a user finds them (the measured-defaults file)
    kernel_config.set_decoder_stack(None)
    kernel_config.set_vit_pair_blocks(None)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ann = synthetic.generate(
                os.path.join(tmp, "data"), num_classes=DISK_CLASSES,
                images_per_class=DISK_IMAGES, image_size=256, seed=SEED)
            work = os.path.join(tmp, "work")
            cfg_path = os.path.join(tmp, "disk_config.py")
            with open(cfg_path, "w") as f:
                f.write(DISK_CONFIG.format(
                    ann=ann, img=os.path.join(tmp, "data", "images"),
                    size=SIZE, k=K, dropout=DROPOUT, queries=QUERIES,
                    episodes=DISK_EPISODES, epochs=DISK_EPOCHS, batch=TRAIN_B,
                    seed=SEED, work=work))
            gen = torch.Generator().manual_seed(SEED)
            model_cfg = main_path_config().model
            bb, head = init_params(gen, model_cfg)
            redraw_zero_inits(bb, head, gen)
            bb_path = os.path.join(tmp, "backbone.pt")
            torch.save({"backbone": bb}, bb_path)
            print(f"[disk] stand-in: {DISK_CLASSES} classes x {DISK_IMAGES} "
                  f"PPM images of 256 px, written in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)

            # --- training from disk
            reset()
            trainer = cli_train.main(["--config", cfg_path, "--backbone-ckpt",
                                      bb_path, "--seed", str(SEED)])
            torch.cuda.synchronize()
            got = counts()
            steps = trainer.step
            print(f"[disk] cli.train: {steps} steps of batch {TRAIN_B} in "
                  f"{DISK_EPOCHS} epochs; launches {got}", flush=True)
            # 12 blocks a step, two to a launch with vit_pair_blocks on
            blocks = got["fused_vit_block"] + 2 * got["fused_vit_block2"]
            if steps < 4 or blocks != 12 * steps or \
                    min(got["flash_mha_train_fwd"],
                        got["flash_mha_train_bwd"]) < steps:
                fail("cli.train did not run through the training kernels")
            with open(os.path.join(work, "train_log.jsonl")) as f:
                log = [json.loads(line) for line in f]
            tb_files = glob.glob(os.path.join(work, "tf_logs", "events.*"))
            scalars = read_scalars(tb_files[0]) if tb_files else []
            tags = {tag for tag, _, _ in scalars}
            ckpt = os.path.join(work, f"epoch_{DISK_EPOCHS}")
            ok = (len(log) == DISK_EPOCHS and os.path.exists(ckpt)
                  and os.path.exists(os.path.join(work, "config.json"))
                  and "train/loss" in tags and "train/lr" in tags
                  and all(np.isfinite(e["train_loss"]) for e in log)
                  and all(np.isfinite(v) for _, v, _ in scalars))
            per_epoch = steps // DISK_EPOCHS
            print(f"[disk] train_log.jsonl {len(log)} epochs, losses "
                  f"{[e['train_loss'] for e in log]}; TensorBoard "
                  f"{len(scalars)} scalars read back, tags {sorted(tags)}; "
                  f"epoch {DISK_EPOCHS}: "
                  f"{log[-1]['time'] * 1e3 / per_epoch:.1f} ms/step with the "
                  f"loader over {per_epoch} steps on {power} (information "
                  f"only) {'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail("cli.train did not leave its files")

            # --- eval from disk: cached, then one episode per row
            results = {}
            for flags in ([], ["--no-cache-supports"]):
                reset()
                res = cli_test.main(
                    [cfg_path, ckpt, "--backbone-ckpt", bb_path, "--work-dir",
                     os.path.join(work, "eval" + str(len(flags))),
                     "--cfg-options", "model.compute_dtype=bfloat16",
                     "model.head_dtype=bfloat16"] + flags)
                torch.cuda.synchronize()
                got = counts()
                results[bool(flags)] = res
                print(f"[disk] cli.test {' '.join(flags) or '(cached)'}: "
                      f"launches {got}", flush=True)
                dec = got["fused_decoder_stack"] + got["fused_decoder_layer"]
                vit = got["fused_vit_block"] + got["fused_vit_block2"]
                if min(vit, got["fused_encoder_stack"], dec,
                       got["flash_mha"]) <= 0 or \
                        got["flash_mha_train_fwd"] or \
                        got["flash_mha_train_bwd"]:
                    fail("cli.test did not run through the eval kernels")
                wd = os.path.join(work, "eval" + str(len(flags)))
                with open(os.path.join(wd, "result_keypoints.json")) as f:
                    recs = json.load(f)
                n_img = DISK_CLASSES * DISK_EPISODES * QUERIES
                if len(recs) != n_img or not os.path.exists(
                        os.path.join(wd, "testing_log.txt")) or not all(
                        np.isfinite(v) for v in res.values()):
                    fail("cli.test did not leave its files or gave "
                         "metrics that are not finite")
            c, u = results[False], results[True]
            worst = max(abs(c[k] - u[k]) for k in c if k.startswith("PCK")
                        or k == "mPCK")
            ok = worst <= DISK_PCK_TOL
            print(f"[disk] {n_img} query images: cached "
                  f"{c['images_per_sec']} img/s (host collate "
                  f"{c['host_collate_seconds']} s, dispatch "
                  f"{c['dispatch_seconds']} s, device wait "
                  f"{c['device_wait_seconds']} s of {c['eval_seconds']} s), "
                  f"uncached {u['images_per_sec']} img/s on {power} "
                  f"(information only); PCK@0.2 cached {c['PCK']:.4f} "
                  f"uncached {u['PCK']:.4f}, mPCK {c['mPCK']:.4f} / "
                  f"{u['mPCK']:.4f}, NME {c['NME']:.4f} / {u['NME']:.4f}; "
                  f"largest PCK difference {worst:.4g} (tol {DISK_PCK_TOL}) "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail("the cached and the uncached disk eval disagree")
    finally:
        kernel_config.set_decoder_stack(False)
        kernel_config.set_vit_pair_blocks(False)


# ------------------------------------------------------ phases 11-13
# Serving, router and demo (edgecape_tpu_torch/cli/serve.py, router.py,
# demo.py): the stage-3 model of cli/demo.py stage3_estimator (learned
# skeleton, Markov bias, the bias attention module, K=100, fp32 compute
# and head dtype, full ViT-S/14), seeded weights, the variant switches as
# the measured-defaults file has them.
SERVE_SIZE, DEMO_SIZE, SERVE_KPTS = 224, 256, 24
# The fp32 head's kernels against their plain versions keep ATOL / RTOL;
# the decoder stack's layers STACK_LAYER_MAX / MEAN (bf16 operands inside
# both, fp32 tokens outside).
# Answers of the kernel path against the strict fp32 path (use_flash=False)
# on the card, on normalised coordinates: the main path's bounds (bf16
# operands in the kernels, and the local soft-argmax can move a keypoint
# by a feature cell on a near tie); learned edge weights (about 1.4 in
# size) within EDGE_TOL: the skeleton's refine attention runs bf16
# operands, which the plain versions' emulation of the kernels' rounding
# points on the CPU puts at 4.4e-5 against fp32.
EDGE_TOL = 2e-3
# The same image answered in another batch (another bucket, another row):
# the fp32 trunk's matmuls are cuBLAS calls, which choose their algorithm,
# and so their order of summation, by the row count; the kernels' bf16
# rounding points downstream carry such a last-bit difference as far as a
# bf16 ulp, as against the strict path (on an H100: a median of 1.4e-4,
# 98.4% of coordinates within a cell). A row-position fault moves most
# keypoints by cells: median about 0.1.
ROW_MEDIAN, ROW_SHARE = 2e-3, PATH_WITHIN_SHARE
# Reloaded weights against a service built with them: the same kernels
# on the same inputs (no atomics); RELOAD_TOL leaves room for nothing more
# than the order of a reduction.
RELOAD_TOL = 1e-5

# (name, module, attribute) of every op-level launch counter
OP_COUNTERS = (
    ("flash_mha", "flash_attention", "launches"),
    ("fused_vit_block", "fused_vit_block", "launches"),
    ("fused_vit_block2", "fused_vit_block", "launches2"),
    ("fused_encoder_stack", "fused_encoder", "stack_launches"),
    ("fused_encoder_layer", "fused_encoder", "launches"),
    ("fused_decoder_layer", "fused_decoder", "launches"),
    ("fused_decoder_stack", "fused_decoder", "stack_launches"))


def _ops_module(name):
    import importlib
    return importlib.import_module("edgecape_tpu_torch.ops." + name)


def zero_counts():
    """Every launch counter to 0: the ops' and each kernel's."""
    from edgecape_tpu_torch.ops import kernels as KN
    from edgecape_tpu_torch.ops import mm_chain
    for _, mod, attr in OP_COUNTERS:
        setattr(_ops_module(mod), attr, 0)
    KN.launches.update(dict.fromkeys(KN.launches, 0))
    mm_chain.launches = 0


def read_counts():
    """(op counts, non-zero kernel counts)."""
    from edgecape_tpu_torch.ops import kernels as KN
    ops = {name: getattr(_ops_module(mod), attr)
           for name, mod, attr in OP_COUNTERS}
    return ops, {k: v for k, v in KN.launch_counts().items() if v}


def path_ops(stack):
    """The kernel ops a stage-3 fp32 forward launches: flash_mha (the
    ViT's attention and the skeleton's refine layers), the encoder stack,
    the decoder as one stack op or one op per layer."""
    return ("flash_mha", "fused_encoder_stack",
            "fused_decoder_stack" if stack else "fused_decoder_layer")


def check_path_counts(what, stack, power):
    """Reads the counters after a path's run: each op of path_ops above 0,
    no bf16 ViT kernel (the trunk is fp32). Returns the op counts."""
    ops, kernels = read_counts()
    need = path_ops(stack)
    vit = {k: kernels.get(k, 0) for k in VIT_KERNELS}
    ok = all(ops[n] > 0 for n in need) and not any(vit.values())
    print(f"[{what}] launches of the kernel ops {ops}; kernels "
          f"{kernels}; expected above 0: {list(need)}, the bf16 ViT "
          f"kernels at 0 ({vit}) on {power} {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail(f"the {what} path did not launch the kernels it runs")
    return ops


def ppm_b64(img):
    """Binary PPM of an RGB uint8 image, base64: the card's machine has no
    cv2, so requests carry PPM."""
    import base64
    h, w = img.shape[:2]
    return base64.b64encode(b"P6\n%d %d\n255\n" % (w, h)
                            + np.ascontiguousarray(img).tobytes()).decode()


def stage3_weights(size, seed):
    """Seeded (backbone, head) state dicts of the stage-3 model, the
    zero-initialised parts redrawn."""
    from edgecape_tpu_torch.cli.demo import stage3_config
    from edgecape_tpu_torch.models.convert import (init_params,
                                                   redraw_zero_inits)
    gen = torch.Generator().manual_seed(seed)
    bb, head = init_params(gen, stage3_config(size).model)
    redraw_zero_inits(bb, head, gen)
    return bb, head


def coord_gap(a, b):
    """(median, max, share within one feature cell) of |a - b|."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(np.median(d)), float(d.max()), float(np.mean(d <= PATH_CELL))


def serve_op_checks(dev, entries):
    """The kernel ops of the serving and demo paths at their shapes, fp32
    in and out: flash_mha on the fp32 ViT's attention (a bucket of 16
    images at 224 px, the demo's support and query at 256 px: 325 keys)
    and on one support group's keypoints; fused_encoder_stack and
    fused_decoder_stack on fp32 tokens of 1 and 16 rows (the serving
    buckets' ends; the eval chunk gives them 510)."""
    import edgecape_tpu_torch.ops.flash_attention as FA
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    from edgecape_tpu_torch.models.transformer import (Decoder, EncoderLayer,
                                                       ensure_some_valid)
    from edgecape_tpu_torch.ops import kernels as KN

    g, rn = seeded_randn(SEED + 11, dev)
    bad = []
    c, ffn, heads, layers, nf, nhop = 256, 384, 8, 3, 128, 5
    hw = (SERVE_SIZE // 14) ** 2
    with torch.no_grad():
        for b, n, h, d, what in (
                (16, 257, 6, 64, "ViT fp32, 224 px"),
                (2, 325, 6, 64, "ViT fp32, 256 px"),
                (1, K, 8, 32, "keypoints fp32, 1 group")):
            q, k, v = (rn(b, n, h, d) for _ in range(3))
            valid = None
            if what.startswith("keypoints"):
                valid = torch.rand(b, n, generator=g).to(dev) > 0.3
                valid[:, 0] = True
            sq, sk, sv = (t.transpose(1, 2) for t in (q, k, v))
            smask = None if valid is None else torch.zeros(
                b, 1, 1, n, device=dev).masked_fill(
                    ~valid[:, None, None, :], -math.inf)
            check_op(
                entries, bad, f"flash_mha ({what})",
                "edgecape_tpu/ops/flash_attention.py:132",
                "edgecape_tpu_torch/ops/flash_attention.py",
                FA.flash_mha(q, k, v, valid), FA.flash_mha_plain(q, k, v,
                                                                 valid),
                lambda: FA.flash_mha(q, k, v, valid),
                lambda: FA.flash_mha_plain(q, k, v, valid),
                bound(2 * nbytes(q) + nbytes(k, v, valid),
                      4 * b * h * n * n * d),
                library=lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=smask),
                counter=(FA, "launches"), copy_gemms=0,
                extra=f"; [B {b}, N {n}, H {h}, D {d}] fp32 in and out; "
                      f"plan {json.dumps(KN.attention_plan(n, n, d))}")

        enc = [randomize(EncoderLayer(c, heads, ffn), rn, dev)
               for _ in range(layers)]
        lib_enc = library_encoder(enc, c, ffn, dev, dtype=torch.float32)
        dec = randomize(Decoder(c, heads, ffn, layers, attn_bias=True,
                                max_hops=nhop - 1, num_feats=nf,
                                use_flash=True), rn, dev)
        for rows in (1, 16):
            tok, pos = rn(rows, hw + K, c), rn(hw + K, c)
            valid = torch.rand(rows, hw + K, generator=g).to(dev) > 0.2
            valid[:, :hw] = True
            outs, refs, x = [], [], tok
            for layer in enc:
                refs.append(FE.fused_encoder_layer_plain(
                    x, pos, valid, layer, num_heads=heads))
                x = FE.fused_encoder_layer(x, pos, valid, layer,
                                           num_heads=heads)
                outs.append(x)
            whole = FE.fused_encoder_stack(tok, pos, valid, enc,
                                           num_heads=heads)
            chain_gap = (whole - x).abs().max().item()
            if whole.dtype != torch.float32 or not torch.equal(whole, x):
                bad.append(f"fused_encoder_stack ({rows} rows): the stack "
                           f"is not its chain of layers ({chain_gap:.3g})")
            pad = ~valid

            def library_stack():
                with torch.inference_mode():
                    y = tok + pos
                    for lib in lib_enc:
                        y = lib(y, src_key_padding_mask=pad)
                return y

            def plain_stack():
                y = tok
                for layer in enc:
                    y = FE.fused_encoder_layer_plain(y, pos, valid, layer,
                                                     num_heads=heads)
                return y

            check_op(
                entries, bad, f"fused_encoder_stack (fp32, {rows} rows)",
                "edgecape_tpu/ops/fused_encoder.py:188",
                "edgecape_tpu_torch/ops/fused_encoder.py",
                torch.stack(outs), torch.stack(refs),
                lambda: FE.fused_encoder_stack(tok, pos, valid, enc,
                                               num_heads=heads),
                plain_stack,
                bound(2 * nbytes(tok) + nbytes(pos, valid)
                      + param_bytes(*enc),
                      layers * (2 * rows * (hw + K) * (4 * c ** 2
                                                       + 2 * c * ffn)
                                + 4 * rows * (hw + K) ** 2 * c)),
                library=library_stack,
                extra=f"; each layer against the plain layer on the "
                      f"kernel's input, fp32 tokens, stack vs its chain of "
                      f"layers {chain_gap:.3g}; post plan "
                      f"{json.dumps(KN.post_plan(rows * (hw + K), c, ffn))}")

            kx = rn(rows, K, c, s=0.5)
            coords = torch.rand(rows, K, 2, generator=g).to(dev) * 0.8 + 0.1
            img, ipos = rn(rows, hw, c, s=0.5), rn(hw, c, s=0.5)
            kvalid = torch.rand(rows, K, generator=g).to(dev) > 0.3
            kvalid[:, 0] = True
            kvalid = ensure_some_valid(kvalid)
            hops = torch.rand(rows, K, K, nhop, generator=g).to(dev)
            adj = torch.rand(rows, 2, K, K, generator=g).to(dev) / K
            args = (kx, coords, img, ipos, kvalid, hops, adj)
            kw = dict(num_heads=heads, num_feats=nf)
            worst, mean = 0.0, 0.0
            for i in range(layers):
                sub = Decoder(c, heads, ffn, 1, attn_bias=True,
                              max_hops=nhop - 1, num_feats=nf)
                sub.layers[0], sub.kpt_branches[0] = dec.layers[i], \
                    dec.kpt_branches[i]
                sub.ref_point_head, sub.norm = dec.ref_point_head, dec.norm
                sub.to(dev).eval()
                o, p_ = FD.fused_decoder_stack(*args, sub, **kw)
                ro, rp = FD.fused_decoder_stack_plain(*args, sub, **kw)
                dd = torch.cat([(o - ro).abs().flatten(),
                                (p_ - rp).abs().flatten()])
                worst = max(worst, dd.max().item())
                mean = max(mean, dd.mean().item())
                if not (torch.isfinite(o).all() and torch.isfinite(p_).all()):
                    bad.append(f"fused_decoder_stack ({rows} rows) layer {i} "
                               f"not finite")
            name = f"fused_decoder_stack (fp32, {rows} rows)"
            ok = worst <= STACK_LAYER_MAX and mean <= STACK_LAYER_MEAN
            whole = FD.fused_decoder_stack(*args, dec, **kw)
            whole_ref = FD.fused_decoder_stack_plain(*args, dec, **kw)
            err = max((a - b).abs().max().item()
                      for a, b in zip(whole, whole_ref))
            ms = time_ms(lambda: FD.fused_decoder_stack(*args, dec, **kw))
            plain_ms = time_ms(lambda: FD.fused_decoder_stack_plain(
                *args, dec, **kw), reps=3)
            r = rows * K
            flops = layers * (
                2 * r * 4 * c ** 2 + 4 * rows * K * K * c
                + 2 * r * (4 + 4 + 2) * c ** 2 + 2 * rows * hw * 4 * c ** 2
                + 4 * rows * K * hw * 2 * c + 2 * r * 3 * c * ffn
                + 2 * rows * 2 * K * K * ffn + 2 * r * (4 * nf * c + c * c)
                + 4 * r * (3 * c * c + 2 * c))
            hid = nhop - 1 + heads
            bnd = bound(nbytes(*args) + param_bytes(dec)
                        + 2 * layers * r * 2 * 4, flops,
                        layers * 2 * rows * K * K * (nhop * hid + hid * heads))
            print(f"[op] {name}: each layer alone against the plain layer "
                  f"max {worst:.4g} mean {mean:.3g} (tol {STACK_LAYER_MAX}, "
                  f"mean {STACK_LAYER_MEAN}); whole stack vs plain "
                  f"{err:.4g} (information); plan "
                  f"{json.dumps(KN.bias_attention_plan(rows, K, heads, 32))}"
                  f"; kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}) library none "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append(name)
            entries[name] = {
                "name": name, "route": "cuda",
                "source": "edgecape_tpu_torch/csrc/kernels.cu",
                "op": "edgecape_tpu_torch/ops/fused_decoder.py",
                "replaces": "edgecape_tpu/ops/fused_decoder.py:531",
                "launches": 0, "max_abs_err": worst, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}
    if bad:
        fail(f"the serving path's kernel ops disagree with their plain "
             f"versions: {bad}")


def serve_requests(rng, n, size=(240, 320)):
    """n seeded RGB images of a camera's 4:3 shape (square-padded and
    resized by the server), as PPM base64."""
    return [ppm_b64(rng.integers(0, 256, size + (3,), dtype=np.uint8))
            for _ in range(n)]


def start_http(handler, port=0):
    """A ThreadingHTTPServer on 127.0.0.1 serving in a daemon thread."""
    import threading
    from http.server import ThreadingHTTPServer
    server = ThreadingHTTPServer(("127.0.0.1", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def call_http(addr, path, payload=None):
    """(status, JSON reply) of a GET (payload None) or a POST."""
    import http.client
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        if payload is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, json.dumps(payload),
                         {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def ok_reply(status, out, what):
    if status != 200:
        fail(f"{what}: status {status}: {out}")
    return out


def serve_path(dev, entries, power):
    """The port's PoseService behind a ThreadingHTTPServer in this
    process: supports, sequential and concurrent /predict, /predict_batch,
    /healthz and /reload, against a service on the strict path; one
    bucket-16 dispatch under the profiler. Returns what the router phase
    reuses."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from edgecape_tpu_torch.cli import serve as S
    from edgecape_tpu_torch.ops import kernel_config
    from edgecape_tpu_torch.train import checkpoint as ck

    kernel_config.set_decoder_stack(None)
    kernel_config.set_vit_pair_blocks(None)
    stack = kernel_config.decoder_stack_default()
    bb, head = stage3_weights(SERVE_SIZE, SEED + 21)
    svc = S.PoseService(size=SERVE_SIZE, device=dev, backbone_state=bb,
                        head_state=head)
    ref = S.PoseService(size=SERVE_SIZE, device=dev, backbone_state=bb,
                        head_state=head, use_flash=False)
    if not svc.est.use_flash or ref.est.use_flash or not ref.est.strict:
        fail("the serving estimators did not take the kernel and the "
             "strict path")
    svc.enable_batching()                   # the CLI's 8 ms window
    server = start_http(S.make_handler(svc))
    addr = server.server_address
    rng = np.random.default_rng(SEED + 22)
    scale = SERVE_SIZE / 320.0              # 240 x 320 images
    kpts = rng.uniform(8, 230, (SERVE_KPTS, 2)).round(1).tolist()
    skel = [[i, i + 1] for i in range(SERVE_KPTS - 1)] + [[0, 12], [5, 20]]
    shots = {1: serve_requests(rng, 1), 5: serve_requests(rng, 5)}
    queries = serve_requests(rng, 20)
    burst = serve_requests(rng, 64)

    def norm(out):
        return np.asarray(out["keypoints"])[:, :2] * scale / SERVE_SIZE

    # warm-up: one support and a query per bucket (allocator, library
    # handles, the kernels' first launches); not counted
    cid = ok_reply(*call_http(addr, "/support", {
        "images": shots[1], "keypoints": kpts, "skeleton": skel}),
        "support")["context_id"]
    for b in (1, 2, 4, 8, 16):
        ok_reply(*call_http(addr, "/predict_batch", {
            "context_id": cid, "images": queries[:b]}), "warm-up")

    zero_counts()
    t0 = time.perf_counter()
    cids = {}
    for s, imgs in shots.items():
        cids[s] = ok_reply(*call_http(addr, "/support", {
            "images": imgs, "keypoints": kpts, "skeleton": skel}),
            f"{s}-shot support")["context_id"]
    sup_s = time.perf_counter() - t0
    lat, singles = [], []
    for q in queries:
        t1 = time.perf_counter()
        singles.append(ok_reply(*call_http(addr, "/predict", {
            "context_id": cids[1], "image": q}), "/predict"))
        lat.append((time.perf_counter() - t1) * 1e3)
    before = dict(svc.stats)
    with ThreadPoolExecutor(16) as pool:
        conc = list(pool.map(lambda q: ok_reply(*call_http(
            addr, "/predict", {"context_id": cids[1], "image": q}),
            "/predict"), queries[:16]))
    mid = dict(svc.stats)
    coalesced = mid["dispatches"] - before["dispatches"]
    ok = coalesced < 16 and mid["max_batch"] <= 16 and \
        mid["queries"] - before["queries"] == 16
    print(f"[serve] 16 concurrent /predict on one context: {coalesced} "
          f"dispatches (fewer than 16), max batch {mid['max_batch']} "
          f"(at most 16) {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("concurrent /predict requests did not coalesce")

    def client(i):
        return [ok_reply(*call_http(addr, "/predict", {
            "context_id": cids[5], "image": q}), "/predict")
            for q in burst[i::8]]

    t1 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(client, range(8)))
    burst_s = time.perf_counter() - t1
    after = dict(svc.stats)
    fill = (after["queries"] - mid["queries"]) / max(
        after["dispatches"] - mid["dispatches"], 1)
    batch = ok_reply(*call_http(addr, "/predict_batch", {
        "context_id": cids[1], "images": queries[:16]}), "/predict_batch")
    hz = ok_reply(*call_http(addr, "/healthz"), "/healthz")
    ops = check_path_counts("serve", stack, power)
    for name in path_ops(stack):
        entries[name]["serve_launches"] = ops[name]
    for name in ("flash_mha (ViT fp32, 224 px)",
                 "flash_mha (keypoints fp32, 1 group)"):
        entries[name]["launches"] = ops["flash_mha"]
    for rows in (1, 16):
        entries[f"fused_encoder_stack (fp32, {rows} rows)"]["launches"] = \
            ops["fused_encoder_stack"]
        entries[f"fused_decoder_stack (fp32, {rows} rows)"]["launches"] = \
            ops["fused_decoder_stack"]
    print(f"[serve] {SERVE_SIZE} px, K {K}, {SERVE_KPTS} annotated keypoints, "
          f"240 x 320 PPM requests, batching window 8 ms, decoder_stack "
          f"{stack}, on {power}: supports (1 and 5 shots) {sup_s * 1e3:.1f} "
          f"ms; 20 sequential /predict p50 {np.percentile(lat, 50):.2f} ms "
          f"p95 {np.percentile(lat, 95):.2f} ms; 64 /predict from 8 "
          f"threads {64 / burst_s:.1f} requests/s, mean batch fill "
          f"{fill:.2f}; /healthz {hz['stats']}", flush=True)

    k5 = ok_reply(*call_http(addr, "/predict_batch", {
        "context_id": cids[5], "images": burst[:16]}), "/predict_batch")
    # the same requests on the strict path, without HTTP
    zero_counts()
    rc = {s: ref.register_support({"images": imgs, "keypoints": kpts,
                                   "skeleton": skel})
          for s, imgs in shots.items()}
    rsingle = [ref.predict({"context_id": rc[1], "image": q})
               for q in queries]
    r5 = ref.predict_batch({"context_id": rc[5], "images": burst[:16]})
    r16 = ref.predict_batch({"context_id": rc[1], "images": queries[:16]})
    plain_launches = sum(read_counts()[1].values())
    got = np.stack([norm(o) for o in singles + k5["results"]])
    want = np.stack([norm(o) for o in rsingle + r5["results"]])
    med, mx, within = coord_gap(got, want)
    edges = np.abs(np.asarray(singles[0]["edge_weights"])[:, 2]
                   - np.asarray(rsingle[0]["edge_weights"])[:, 2]).max()
    edges5 = np.abs(np.asarray(k5["edge_weights"])[:, 2]
                    - np.asarray(r5["edge_weights"])[:, 2]).max()
    ok = (med <= PATH_MEDIAN_TOL and within >= PATH_WITHIN_SHARE
          and max(edges, edges5) <= EDGE_TOL and plain_launches == 0
          and np.isfinite(got).all())
    print(f"[serve] answers vs the strict path (use_flash=False, same "
          f"weights, same requests, 1 and 5 shots): median |d| {med:.4g} "
          f"(tol {PATH_MEDIAN_TOL}), max {mx:.4g}, share within "
          f"{PATH_CELL:.4g}: {within:.4f} (tol >= {PATH_WITHIN_SHARE}); edge "
          f"weights max |d| {max(edges, edges5):.3g} (tol {EDGE_TOL}); "
          f"hand-written launches on the strict path {plain_launches} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the served answers disagree with the strict path")
    rows = {}
    for what, outs in (("/predict_batch of 16", batch["results"]),
                       ("16 concurrent /predict", conc)):
        rows[what] = coord_gap([norm(o) for o in outs],
                               [norm(o) for o in singles[:16]])
    strict_rows = coord_gap([norm(o) for o in r16["results"]],
                            [norm(o) for o in rsingle[:16]])
    ok = all(m <= ROW_MEDIAN and w >= ROW_SHARE for m, _, w in rows.values())
    print(f"[serve] the same 16 images against their sequential single "
          f"/predict answers (bucket 1): " + "; ".join(
              f"{k}: median {m:.3g} max {x:.3g} share within a cell "
              f"{w:.4f}" for k, (m, x, w) in rows.items())
          + f" (tol median {ROW_MEDIAN}, share >= {ROW_SHARE}); on the "
          f"strict path a bucket of 16 against single answers: median "
          f"{strict_rows[0]:.3g} max {strict_rows[1]:.3g} (information: "
          f"cuBLAS's order of summation by row count) "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("an answer depends on its batch or its row")

    # /reload: a checkpoint of other seeded head weights
    _, other = stage3_weights(SERVE_SIZE, SEED + 23)
    tmp = tempfile.TemporaryDirectory()
    ckpt = os.path.join(tmp.name, "other_head")
    ck.save_checkpoint(ckpt, {"model": other})
    n_ctx = len(svc.contexts)
    out = ok_reply(*call_http(addr, "/reload", {"checkpoint": ckpt}),
                   "/reload")
    stale, _ = call_http(addr, "/predict", {"context_id": cids[1],
                                            "image": queries[0]})
    cid = ok_reply(*call_http(addr, "/support", {
        "images": shots[1], "keypoints": kpts, "skeleton": skel}),
        "support")["context_id"]
    new = ok_reply(*call_http(addr, "/predict_batch", {
        "context_id": cid, "images": queries[:4]}), "/predict_batch")
    fresh = S.PoseService(size=SERVE_SIZE, device=dev, backbone_state=bb,
                          head_state=other)
    fc = fresh.register_support({"images": shots[1], "keypoints": kpts,
                                 "skeleton": skel})
    want = fresh.predict_batch({"context_id": fc, "images": queries[:4]})
    gap = np.abs(np.stack([norm(o) for o in new["results"]])
                 - np.stack([norm(o) for o in want["results"]])).max()
    moved = np.abs(np.stack([norm(o) for o in new["results"]])
                   - np.stack([norm(o) for o in singles[:4]])).max()
    ok = (out["contexts_dropped"] == n_ctx >= 3 and stale == 400
          and gap <= RELOAD_TOL and moved > 1e-3)
    print(f"[serve] /reload of other seeded head weights: "
          f"{out['contexts_dropped']} contexts dropped (of {n_ctx}), an old "
          f"context_id answered {stale}; new answers vs a service built "
          f"with those weights max |d| {gap:.3g} (tol {RELOAD_TOL}), moved "
          f"{moved:.3g} from the old weights' {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("/reload did not swap the weights")

    imgs16 = np.stack([svc._prep(svc._decode_image(q))[0]
                       for q in queries[:16]])
    walls = []
    for _ in range(7):
        t1 = time.perf_counter()
        svc._dispatch(cid, imgs16)
        walls.append((time.perf_counter() - t1) * 1e3)
    one = []
    for _ in range(7):
        t1 = time.perf_counter()
        svc._dispatch(cid, imgs16[:1])
        one.append((time.perf_counter() - t1) * 1e3)
    print(f"[serve] a dispatch called directly (no HTTP, no batcher, images "
          f"prepared), median of 7 on {power}: bucket 16 "
          f"{np.median(walls):.2f} ms ({16e3 / np.median(walls):.1f} img/s), "
          f"bucket 1 {np.median(one):.2f} ms", flush=True)
    profile(lambda: svc._dispatch(cid, imgs16),
            "one bucket-16 dispatch of the server (16 images, 224 px, fp32)",
            power, rows=16)
    server.shutdown()
    server.server_close()
    svc.batcher.stop()
    svc.batcher = None
    del ref
    torch.cuda.empty_cache()
    return svc, fresh, ckpt, tmp, shots[1], kpts, skel, queries[:2]


def router_path(dev, entries, power, served):
    """Two services on the one card behind the port's router, each behind
    its own HTTP server: sticky /predict, a rolling /reload, one
    replica's server shut down (503 "context lost", supports routed to the
    other) and rejoining once it answers again."""
    from edgecape_tpu_torch.cli import router as R
    from edgecape_tpu_torch.cli import serve as S
    from edgecape_tpu_torch.ops import kernel_config

    svc_a, svc_b, ckpt, tmp, shot, kpts, skel, queries = served
    t0 = time.perf_counter()
    servers = [start_http(S.make_handler(s)) for s in (svc_a, svc_b)]
    ports = [s.server_address[1] for s in servers]
    router = R.Router([f"http://127.0.0.1:{p}" for p in ports],
                      probe_interval=0)
    front = start_http(R.make_handler(router))
    addr = front.server_address
    sup = {"images": shot, "keypoints": kpts, "skeleton": skel}
    zero_counts()
    cids = [ok_reply(*call_http(addr, "/support", sup), "router /support")[
        "context_id"] for _ in range(2)]
    homes = [router.routes[c] for c in cids]
    q0 = [s.stats["queries"] for s in (svc_a, svc_b)]
    for cid in cids * 3:
        ok_reply(*call_http(addr, "/predict", {"context_id": cid,
                                               "image": queries[0]}),
                 "router /predict")
    served_q = [s.stats["queries"] - q for s, q in zip((svc_a, svc_b), q0)]
    sticky = homes[0] is not homes[1] and served_q == [3, 3]
    gens = [s.generation for s in (svc_a, svc_b)]
    n_ctx = len(svc_a.contexts) + len(svc_b.contexts)
    out = ok_reply(*call_http(addr, "/reload", {"checkpoint": ckpt}),
                   "router /reload")
    lost, _ = call_http(addr, "/predict", {"context_id": cids[0],
                                           "image": queries[0]})
    rolled = (out["ok"] and out["contexts_dropped"] == n_ctx and lost == 503
              and [s.generation for s in (svc_a, svc_b)]
              == [g + 1 for g in gens])
    cids = [ok_reply(*call_http(addr, "/support", sup), "router /support")[
        "context_id"] for _ in range(2)]
    down = router.routes[cids[0]]
    i_down = [r.url for r in router.replicas].index(down.url)
    servers[i_down].shutdown()
    servers[i_down].server_close()
    st_lost, body = call_http(addr, "/predict", {"context_id": cids[0],
                                                 "image": queries[0]})
    st_other, _ = call_http(addr, "/predict", {"context_id": cids[1],
                                               "image": queries[0]})
    elsewhere = ok_reply(*call_http(addr, "/support", sup), "router /support")
    failover = (st_lost == 503 and "context lost" in body["error"]
                and st_other == 200 and not down.alive
                and router.routes[elsewhere["context_id"]] is not down)
    servers[i_down] = start_http(S.make_handler((svc_a, svc_b)[i_down]),
                                 port=ports[i_down])
    router._probe_one(down)
    back = ok_reply(*call_http(addr, "/support", sup), "router /support")
    rejoined = down.alive and router.routes[back["context_id"]] is down
    ok_reply(*call_http(addr, "/predict", {
        "context_id": back["context_id"], "image": queries[1]}),
        "router /predict after the rejoin")
    stack = kernel_config.decoder_stack_default()
    ops = check_path_counts("router", stack, power)
    for name in path_ops(stack):
        entries[name]["router_launches"] = ops[name]
    ok = sticky and rolled and failover and rejoined
    print(f"[router] 2 replicas on {power}: sticky /predict {served_q} "
          f"({'OK' if sticky else 'FAIL'}); rolling /reload "
          f"{out['contexts_dropped']} contexts dropped (of {n_ctx}), old "
          f"context {lost} "
          f"({'OK' if rolled else 'FAIL'}); replica {i_down} shut down: its "
          f"context {st_lost} ({body.get('error')}), the other's "
          f"{st_other}, new support elsewhere "
          f"({'OK' if failover else 'FAIL'}); rejoined once up again "
          f"({'OK' if rejoined else 'FAIL'}); "
          f"{time.perf_counter() - t0:.2f} s; router stats "
          f"{router.healthz()['stats']}", flush=True)
    for s in servers + [front]:
        s.shutdown()
        s.server_close()
    router.close()
    tmp.cleanup()
    if not ok:
        fail("the router did not route, roll or fail over")


def demo_path(dev, entries, power):
    """The demo's inference (cli/demo.py infer) at its default 256 px
    (325 ViT tokens, which flash_mha takes and the bf16 fused block does
    not) on one support / query pair with an annotation dict: launch
    counters, predictions against the strict path on the card, the
    figure; a bf16 model at 256 px is refused when it is built."""
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.cli import demo as D
    from edgecape_tpu_torch.ops import kernel_config
    from edgecape_tpu_torch.tools import bench_attention as BA

    bb, head = stage3_weights(DEMO_SIZE, SEED + 31)
    est = D.stage3_estimator(DEMO_SIZE, backbone_state=bb, head_state=head,
                             device=dev)
    ref = D.stage3_estimator(DEMO_SIZE, backbone_state=bb, head_state=head,
                             device=dev, use_flash=False)
    rng = np.random.default_rng(SEED + 32)
    sup = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    qry = rng.integers(0, 256, (400, 300, 3), dtype=np.uint8)
    ann = {"keypoints": rng.uniform(10, 470, (60, 2)).round(1).tolist(),
           "skeleton": [[i, i + 1] for i in range(59)]}
    D.infer(est, sup, qry, ann)                     # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = D.infer(est, sup, qry, ann)
    wall = time.perf_counter() - t0
    stack = kernel_config.decoder_stack_default()
    ops = check_path_counts("demo", stack, power)
    for name in path_ops(stack):
        entries[name]["demo_launches"] = ops[name]
    entries["flash_mha (ViT fp32, 256 px)"]["launches"] = ops["flash_mha"]
    want = D.infer(ref, sup, qry, ann)
    med, mx, within = coord_gap(res["pred_px"] / DEMO_SIZE,
                                want["pred_px"] / DEMO_SIZE)
    adj = np.abs(res["raw_adj"] - want["raw_adj"]).max()
    ok = (med <= PATH_MEDIAN_TOL and within >= PATH_WITHIN_SHARE
          and adj <= EDGE_TOL and np.isfinite(res["pred_px"]).all())
    print(f"[demo] infer at {DEMO_SIZE} px (fp32, 325 ViT tokens), 60 "
          f"keypoints, on {power}: {wall * 1e3:.1f} ms; vs the strict path "
          f"median |d| {med:.4g} (tol {PATH_MEDIAN_TOL}), max {mx:.4g}, share "
          f"within {PATH_CELL:.4g}: {within:.4f} (tol >= "
          f"{PATH_WITHIN_SHARE}); learned adjacency max |d| {adj:.3g} (tol "
          f"{EDGE_TOL}) {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the demo's predictions disagree with the strict path")
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"[demo] figure not written: matplotlib does not import "
              f"({e})", flush=True)
    else:
        from edgecape_tpu_torch.utils.visualization import plot_results
        with tempfile.TemporaryDirectory() as out_dir:
            path = plot_results(res["support"], res["query"], res["joints"],
                                res["visible"], res["pred_px"],
                                res["skeleton"], res["raw_adj"], out_dir)
            size = os.path.getsize(path)
        print(f"[demo] figure written: {os.path.basename(path)}, {size} "
              f"bytes", flush=True)
        if size < 1000:
            fail("the demo's figure is empty")
    cfg = D.stage3_config(DEMO_SIZE)
    cfg.model.compute_dtype = cfg.model.head_dtype = "bfloat16"
    err = []

    def build():
        try:
            PoseEstimator(cfg, bb, head, device=dev)
        except ValueError as e:
            err.append(str(e))

    ran = BA.launched(build)
    msg = err[0] if err else ""
    ok = "fused_vit_block (" in msg and "flash_mha" not in msg and not ran
    print(f"[demo] the same model in bf16 at {DEMO_SIZE} px, built for the "
          f"card: refused {bool(err)} ({msg or 'no error'}); hand-written "
          f"launches {sum(ran.values())} {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("a bf16 model at 256 px was not refused when it was built")
    del est, ref
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 14
# [dist]: ranks of the process group, the per-rank rows of the global
# training batch of TRAIN_B, training steps, cached eval episode groups
# (of QUERIES queries; two a chunk, so one process and each rank evaluate
# chunks of the same groups) and a rank's time limit in seconds.
DIST_RANKS, DIST_STEPS, DIST_GROUPS, DIST_TIMEOUT = 2, 2, 4, 600
DIST_EVAL_BATCH = 2 * QUERIES
# The reduced gradient of step 1 (8 + 8 rows, averaged over the ranks)
# against one process's gradients of the same two 8-row blocks,
# averaged: the same kernels on the same shapes, so equal but for the
# order of one fp32 sum (DIST_EXACT relative L2; a missing or summed
# reduce is off by 0.5-1). Against one process's step on all 16 rows:
# the frozen trunk that both paths share gives an image other bits in a
# call on 32 images than on 16 (#1's vit_mlp_kernel: a row's result
# depends on where it sits in its 128-row tile; on an H100 118 of 3.2
# million elements after one block, 12% of the features after twelve),
# which moves the head's gradients by about 0.03 relative L2 on the
# kernel path and on the plain path alike (measured 0.029 / 0.026, worst
# tensor 0.067 / 0.054; trunk_row_invariance prints where), so the
# training path's bounds for kernel against plain hold
# (GRAD_REL_L2, GRAD_TENSOR_REL_L2); the losses within DIST_LOSS_REL
# relative (measured 8.1e-5), the PCK probe within one keypoint of one
# sample (1 / (0.9 K) / TRAIN_B = 7e-4). The same bounds hold the reduced
# kernel-path gradient against the plain path (use_flash=False) at 8 and
# at 16 rows, so the kernels are checked at the ranks' own shapes. Eval:
# the same chunks through the same kernels, so keypoints within 1e-3 px
# and metrics within 1e-6; against the plain path's chunks, the main
# path's bounds for that pair (PATH_MEDIAN_TOL, PATH_WITHIN_SHARE).
DIST_EXACT, DIST_LOSS_REL, DIST_ACC = 1e-6, 1e-3, 1e-3
DIST_PX, DIST_METRIC = 1e-3, 1e-6


def dist_config(work_dir):
    """The [dist] ranks' training configuration: the stage-3 training
    path's at dropout 0, one epoch of DIST_STEPS steps, a checkpoint at
    its end."""
    from edgecape_tpu_torch import config as C
    cfg = C.stage3_config(train_config(work_dir))
    cfg.model = C.replace(cfg.model, dropout=0.0)
    return cfg


def dist_weights():
    """(backbone, head) of the training ranks and (backbone, head) of the
    eval ranks: seeded, the zero-initialised parts redrawn."""
    from edgecape_tpu_torch.models.convert import (init_params,
                                                   redraw_zero_inits)
    out = []
    for seed, cfg in ((SEED + 50, dist_config(".").model),
                      (SEED + 60, main_path_config().model)):
        gen = torch.Generator().manual_seed(seed)
        bb, head = init_params(gen, cfg)
        redraw_zero_inits(bb, head, gen)
        out += [bb, head]
    return out


class DistBatch:
    """The global training batch of TRAIN_B rows, re-fed every step; a
    rank's loader yields its contiguous row block (the factory's
    `shard=(rank, world)`), one process's the whole batch."""
    num_shots = 1

    def __init__(self):
        self.batch = RefedBatch(1, np.random.default_rng(SEED + 51)).batch
        self.rows = slice(None)

    def __len__(self):
        return DIST_STEPS * TRAIN_B

    def resample_episodes(self):
        pass

    def loader(self, ds, bs, shard=None, **kw):
        if shard is not None:
            rank, world = shard
            per = TRAIN_B // world
            self.rows = slice(rank * per, (rank + 1) * per)
        return self

    def epoch(self):
        for _ in range(DIST_STEPS):
            yield {k: v[self.rows] for k, v in self.batch.items()}


def rank_device(backend, rank):
    """A rank's card: its own under NCCL, the first one (shared) under
    gloo."""
    return torch.device("cuda", rank if backend == "nccl" else 0)


def dist_rank(argv):
    """One rank of the [dist] phase (a subprocess of the smoke): joins the
    process group, trains DIST_STEPS steps of its row block through the
    kernels, then evaluates its share of DIST_GROUPS episode groups; writes
    its launch counts, step times, metrics, a hash of its parameters
    after the last step and (rank 0) the reduced gradients of step 1."""
    import argparse
    import hashlib
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.eval.runner import run_eval
    from edgecape_tpu_torch.ops import kernel_config
    from edgecape_tpu_torch.parallel import multihost
    from edgecape_tpu_torch.train import checkpoint as ck
    from edgecape_tpu_torch.train.loop import Trainer
    import edgecape_tpu_torch.ops.flash_attention as FA

    p = argparse.ArgumentParser()
    for flag in ("--dist-rank", "--dist-world"):
        p.add_argument(flag, type=int, required=True)
    for flag in ("--dist-init", "--dist-backend", "--dist-out"):
        p.add_argument(flag, required=True)
    a = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = rank_device(a.dist_backend, a.dist_rank)
    multihost.initialize(a.dist_init, a.dist_world, a.dist_rank,
                         backend=a.dist_backend, device=dev)
    kernel_config.set_decoder_stack(False)
    kernel_config.set_vit_pair_blocks(False)
    bb, head, ebb, ehead = dist_weights()
    cfg = dist_config(os.path.join(a.dist_out, "train"))
    cfg.load_from = os.path.join(a.dist_out, "seeded")
    data = DistBatch()
    tr = Trainer(cfg, data, data.loader, backbone_state=bb, device=dev,
                 log_fn=lambda *msg: None)
    out = {"rank": a.dist_rank, "device": str(dev),
           "name": torch.cuda.get_device_name(dev), "steps": []}
    inner = tr._step_fn

    def spy(batch, generator, step):
        t0 = time.perf_counter()
        metrics = inner(batch, generator, step)
        torch.cuda.synchronize()
        out["steps"].append({"ms": (time.perf_counter() - t0) * 1e3,
                             "rows": int(batch["img_q"].shape[0]),
                             **{k: float(v) for k, v in metrics.items()}})
        if step == 0 and a.dist_rank == 0:
            torch.save({n: q.grad.float().cpu() for n, q in
                        tr.model.named_parameters() if q.grad is not None},
                       os.path.join(a.dist_out, "grads.pt"))
        return metrics

    tr._step_fn = spy
    zero_counts()
    FA.launches_fwd = FA.launches_bwd = 0
    tr.fit()
    torch.cuda.synchronize()
    ops, kern = read_counts()
    out["train_launches"] = {"fused_vit_block": ops["fused_vit_block"],
                             "flash_mha_train_fwd": FA.launches_fwd,
                             "flash_mha_train_bwd": FA.launches_bwd,
                             "kernels": kern}
    digest = hashlib.sha256()
    for name, t in sorted(tr.model.state_dict().items()):
        digest.update(name.encode())
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    out["params_sha256"] = digest.hexdigest()
    out["checkpoint"] = ck.latest_checkpoint(cfg.work_dir) is not None
    del tr
    est = PoseEstimator(main_path_config(), ebb, ehead, device=dev)
    val = EvalEpisodes(np.random.default_rng(SEED + 61), groups=DIST_GROUPS,
                       queries=QUERIES)
    zero_counts()
    res = run_eval(val, est, batch_size=DIST_EVAL_BATCH,
                   res_folder=os.path.join(a.dist_out, f"eval{a.dist_rank}"),
                   progress=False, cache_supports=True)
    torch.cuda.synchronize()
    ops, kern = read_counts()
    out["eval_launches"] = {**ops, "kernels": kern}
    out["eval"] = {k: v for k, v in res.items() if not k.endswith(
        ("_seconds", "per_sec"))}
    with open(os.path.join(a.dist_out, f"rank{a.dist_rank}.json"),
              "w") as f:
        json.dump(out, f)
    multihost.shutdown()


def dist_run(backend, tmp, power):
    """Starts the DIST_RANKS ranks (subprocesses of this script), waits
    for them (each within DIST_TIMEOUT) and returns their outputs; a rank
    that fails or times out fails the smoke."""
    out = os.path.join(tmp, backend)
    os.makedirs(out)
    torch.save({"model": dist_weights()[1]}, os.path.join(out, "seeded"))
    procs = []
    for r in range(DIST_RANKS):
        log = open(os.path.join(out, f"log{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
             "--dist-world", str(DIST_RANKS), "--dist-init",
             "file://" + os.path.join(out, "rendezvous"), "--dist-backend",
             backend, "--dist-out", out], stdout=log,
            stderr=subprocess.STDOUT), log))
    t0 = time.perf_counter()
    rcs = []
    try:
        for proc, _ in procs:
            left = max(1.0, DIST_TIMEOUT - (time.perf_counter() - t0))
            try:
                rcs.append(proc.wait(timeout=left))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    wall = time.perf_counter() - t0
    if rcs != [0] * DIST_RANKS:
        for r in range(DIST_RANKS):
            with open(os.path.join(out, f"log{r}.txt")) as f:
                print(f"[dist] rank {r} log (tail):\n{f.read()[-4000:]}",
                      flush=True)
        fail(f"[dist] {backend} ranks ended with {rcs}")
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    print(f"[dist] {backend}: {DIST_RANKS} ranks on "
          f"{[x['device'] + ' ' + x['name'] for x in ranks]} ran in "
          f"{wall:.1f} s on {power}", flush=True)
    return out, ranks


def dist_reference(dev, tmp):
    """One process on `dev`, with the ranks' starting weights, on the
    kernel path and on the plain path (use_flash=False), keyed by
    use_flash: the step-1 metrics and gradients (no update) of all
    TRAIN_B rows and of each rank's row block; the cached eval of all
    DIST_GROUPS groups in the ranks' chunks (metrics, records)."""
    from edgecape_tpu_torch import config as C
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.eval.runner import run_eval
    from edgecape_tpu_torch.train.loop import (Trainer, batch_to_tensors,
                                               make_loss_fn)
    bb, head, ebb, ehead = dist_weights()
    torch.save({"model": head}, os.path.join(tmp, "one_seeded"))
    data = DistBatch()
    per = TRAIN_B // DIST_RANKS
    out = {}
    for flash in (True, False):
        cfg = dist_config(os.path.join(tmp, f"one{flash}"))
        cfg.model = C.replace(cfg.model, use_flash=flash)
        cfg.load_from = os.path.join(tmp, "one_seeded")
        tr = Trainer(cfg, data, data.loader, backbone_state=bb, device=dev,
                     log_fn=lambda *a: None)
        loss_fn = make_loss_fn(tr.model, tr.backbone, tr.cfg)
        if flash:
            batch = batch_to_tensors(data.batch, dev)
            imgs = torch.cat([batch["img_s"].flatten(0, 1), batch["img_q"]])
            parts = trunk_row_invariance(tr.backbone, imgs)
            print(f"[dist] the training step's trunk on {imgs.shape[0]} "
                  f"images in one call vs two calls of half as many, "
                  f"differing elements in the first / second half of all "
                  f"(max |d| over max |out|): " + ", ".join(
                      f"{name} {n0} / {n1} of {m} ({r:.3g})"
                      for name, n0, n1, m, r in parts), flush=True)
        steps = {}
        for name, rows in [("all", slice(None))] + [
                (r, slice(r * per, (r + 1) * per)) for r in range(DIST_RANKS)]:
            tr.model.train()
            tr.model.zero_grad(set_to_none=True)
            total, metrics = loss_fn(batch_to_tensors(
                {k: v[rows] for k, v in data.batch.items()}, dev),
                tr.generator)
            total.backward()
            steps[name] = ({k: float(v) for k, v in metrics.items()},
                           {n: q.grad.float().cpu() for n, q in
                            tr.model.named_parameters() if q.grad is not None})
        del tr
        ecfg = main_path_config()
        ecfg.model.use_flash = flash
        est = PoseEstimator(ecfg, ebb, ehead, device=dev)
        val = EvalEpisodes(np.random.default_rng(SEED + 61),
                           groups=DIST_GROUPS, queries=QUERIES)
        folder = os.path.join(tmp, f"one_eval{flash}")
        res = run_eval(val, est, batch_size=DIST_EVAL_BATCH,
                       res_folder=folder, progress=False, cache_supports=True)
        with open(os.path.join(folder, "result_keypoints.json")) as f:
            records = json.load(f)
        del est
        torch.cuda.empty_cache()
        out[flash] = (steps, {k: v for k, v in res.items() if not k.endswith(
            ("_seconds", "per_sec"))}, records)
    return out


def trunk_row_invariance(backbone, images):
    """Whether the frozen trunk of the training step (dinov2.fast_forward:
    the bf16 patch embedding, then #1's three kernels per block) gives an
    image the same bits in one call on all `images` as in calls on each
    half: [(stage, differing elements in the first half's images, in the
    second half's, all elements, largest |d| over the largest |output|)]
    for the patch embedding, each kernel of the first block on the same
    inputs, and the whole trunk. The second half's rows sit at another
    offset in the kernels' 128-row tiles in the one call; the first
    half's at the same."""
    import torch.nn.functional as F
    from edgecape_tpu_torch.models import dinov2
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops.fused_vit_block import _prepare
    c, bf = backbone.cfg, torch.bfloat16
    half = images.shape[0] // 2
    w = K.module_weights(backbone.blocks[0], "_kernel_weights", _prepare)

    def embed(imgs):
        return F.linear(dinov2._patches(imgs.to(bf), c.patch_size)[0],
                        backbone.patch_embed.weight.to(bf),
                        backbone.patch_embed.bias.to(bf))

    def qkv(x):
        b, n, d = x.shape
        return K.vit_qkv(x.reshape(b * n, d), w, eps=c.ln_eps).view(b, n, -1)

    def attn(q, x):
        return K.vit_attn(q, x, w, out_dtype=torch.float32)

    def mlp(x1):
        b, n, d = x1.shape
        return K.vit_mlp(x1.reshape(b * n, d), w, eps=c.ln_eps,
                         out_dtype=bf)[0].view(b, n, d)

    out = []
    with torch.no_grad():
        tokens = torch.cat([backbone.cls_token.to(bf).expand(
            images.shape[0], 1, c.embed_dim), embed(images)], dim=1) \
            + backbone.pos_embed.to(bf)
        q = qkv(tokens)
        x1 = attn(q, tokens)
        for name, fn, args in (
                ("patch embedding", embed, (images,)),
                ("vit_qkv_kernel", qkv, (tokens,)),
                ("vit_attn_kernel", attn, (q, tokens)),
                ("vit_mlp_kernel", mlp, (x1,)),
                ("whole trunk", lambda x: dinov2.fast_forward(backbone, x),
                 (images,))):
            a = fn(*args)
            b = torch.cat([fn(*(t[:half] for t in args)),
                           fn(*(t[half:] for t in args))])
            diff = (a != b).reshape(a.shape[0], -1).sum(dim=1)
            out.append((name, int(diff[:half].sum()), int(diff[half:].sum()),
                        a.numel(), ((a.float() - b.float()).abs().max()
                                    / a.float().abs().max()).item()))
    return out


def grad_gap(got, want):
    """(relative L2 error over all gradients, the worst relative L2 error
    of a tensor of at least a thousandth of the largest norm, its name,
    the largest absolute error on a key-projection bias: those have no
    gradient in exact arithmetic, so their norms stay below the
    thousandth and they are compared absolutely)."""
    names = sorted(want)
    num = math.sqrt(sum(((got[n] - want[n]) ** 2).sum().item()
                        for n in names))
    den = math.sqrt(sum((want[n] ** 2).sum().item() for n in names))
    top = max(want[n].norm().item() for n in names)
    worst, worst_name = 0.0, ""
    for n in names:
        if want[n].norm().item() >= 1e-3 * top:
            rel = ((got[n] - want[n]).norm() / want[n].norm()).item()
            if rel > worst:
                worst, worst_name = rel, n
    kb = max(((got[n] - want[n]).abs().max().item() for n in names
              if "k_proj.bias" in n), default=0.0)
    return num / den, worst, worst_name, kb


def dist_gates(backend, out, ranks, ref, entries, power):
    """The gates of one [dist] run against the one-process reference, on
    the kernel path and on the plain path (dist_reference)."""
    steps, eval_res, records = ref[True]
    plain_steps, _, plain_records = ref[False]
    bad = []
    got = torch.load(os.path.join(out, "grads.pt"))
    metrics, grads = steps["all"]

    def mean_of_blocks(by_rows):
        return {n: sum(by_rows[r][1][n] for r in range(DIST_RANKS))
                / DIST_RANKS for n in by_rows["all"][1]}

    mean = mean_of_blocks(steps)
    plain, plain_mean = plain_steps["all"][1], mean_of_blocks(plain_steps)
    if not set(got) == set(grads) == set(mean) == set(plain):
        bad.append("the ranks' gradients cover other parameters")
    exact = grad_gap(got, mean)
    whole = grad_gap(got, grads)
    own = grad_gap(mean, grads)
    # the kernels at the ranks' 8 rows against the plain path at 8 and at
    # 16 rows; the plain path's own 16-rows-vs-blocks gap, beside the
    # kernel path's (own), shows whether the kernels of the head add to it
    vs_plain = grad_gap(got, plain_mean)
    vs_plain16 = grad_gap(got, plain)
    plain_own = grad_gap(plain_mean, plain)
    if exact[0] > DIST_EXACT or whole[0] > GRAD_REL_L2 \
            or whole[1] > GRAD_TENSOR_REL_L2:
        bad.append("the reduced gradient disagrees with one process's")
    if any(g[0] > GRAD_REL_L2 or g[1] > GRAD_TENSOR_REL_L2
           for g in (vs_plain, vs_plain16)):
        bad.append("the reduced kernel-path gradient disagrees with the "
                   "plain path's")
    step1 = ranks[0]["steps"][0]
    loss_gap = max(abs(step1[k] - v) / max(1.0, abs(v))
                   for k, v in metrics.items() if k != "acc_pose")
    half_gap = max(abs(step1[k] - np.mean([steps[r][0][k]
                                           for r in range(DIST_RANKS)]))
                   / max(1.0, abs(v))
                   for k, v in metrics.items() if k != "acc_pose")
    acc_gap = abs(step1["acc_pose"] - metrics["acc_pose"])
    if loss_gap > DIST_LOSS_REL or half_gap > DIST_EXACT \
            or acc_gap > DIST_ACC:
        bad.append("the step's loss dict disagrees with one process's")
    if any(r["steps"][i] != ranks[0]["steps"][i] | {"ms": r["steps"][i]["ms"]}
           for r in ranks for i in range(DIST_STEPS)):
        bad.append("the ranks logged different metrics")
    hashes = {r["params_sha256"] for r in ranks}
    if len(hashes) != 1:
        bad.append("the parameters after the last step differ between ranks")
    if not ranks[0]["checkpoint"]:
        bad.append("no checkpoint was written")
    rows = [s["rows"] for r in ranks for s in r["steps"]]
    if rows != [TRAIN_B // DIST_RANKS] * (DIST_RANKS * DIST_STEPS):
        bad.append(f"the ranks stepped on {rows} rows")
    print(f"[dist] {backend} training, {DIST_STEPS} steps of "
          f"{TRAIN_B // DIST_RANKS} rows a rank (global batch {TRAIN_B}, "
          f"dropout 0, kernels on): step-1 reduced gradient vs the mean of "
          f"one process's gradients of the same row blocks: relative L2 "
          f"{exact[0]:.3g} (tol {DIST_EXACT}), worst tensor {exact[1]:.3g}, "
          f"losses {half_gap:.3g}; vs one process's step on the {TRAIN_B} "
          f"rows: relative L2 {whole[0]:.3g} (tol {GRAD_REL_L2}), worst "
          f"tensor {whole[1]:.3g} {whole[2]} (tol {GRAD_TENSOR_REL_L2}), "
          f"key-projection biases max |d| {whole[3]:.3g}, losses max "
          f"relative gap {loss_gap:.3g} (tol {DIST_LOSS_REL}), acc_pose "
          f"{step1['acc_pose']:.4f} vs {metrics['acc_pose']:.4f} (tol "
          f"{DIST_ACC}); one process alone, its {TRAIN_B} rows vs the mean "
          f"of its row blocks: relative L2 {own[0]:.3g}, worst tensor "
          f"{own[1]:.3g} (the row count's share); parameters after step "
          f"{DIST_STEPS} {'bit-equal' if len(hashes) == 1 else 'DIFFERENT'} "
          f"across ranks", flush=True)
    print(f"[dist] {backend} reduced kernel-path gradient vs the plain path "
          f"(use_flash=False, one process, same weights and rows): vs the "
          f"mean of its {TRAIN_B // DIST_RANKS}-row blocks relative L2 "
          f"{vs_plain[0]:.3g}, worst tensor {vs_plain[1]:.3g} {vs_plain[2]}; "
          f"vs its {TRAIN_B} rows {vs_plain16[0]:.3g}, worst tensor "
          f"{vs_plain16[1]:.3g} (tol {GRAD_REL_L2} / {GRAD_TENSOR_REL_L2}); "
          f"witness, the plain path's {TRAIN_B} rows vs the mean of its "
          f"row blocks: relative L2 {plain_own[0]:.3g}, worst tensor "
          f"{plain_own[1]:.3g} (the kernel path's: {own[0]:.3g})",
          flush=True)
    for r in ranks:
        print(f"[dist] {backend} rank {r['rank']} step ms "
              f"{[round(s['ms'], 3) for s in r['steps']]} (the first a "
              f"warm-up; ranks share {'one card' if backend == 'gloo' else 'nothing'}: "
              f"information only, no scaling figure) on {power}", flush=True)
    # eval: the records of the gather against one process's
    with open(os.path.join(out, "eval0", "result_keypoints.json")) as f:
        gathered = json.load(f)
    same_ids = [r["bbox_id"] for r in gathered] == \
        [r["bbox_id"] for r in records]
    px = max((np.abs(np.asarray(a["keypoints"]) - np.asarray(b["keypoints"]))
              .max() for a, b in zip(gathered, records)), default=math.inf)
    mgap = max(abs(ranks[0]["eval"][k] - v) for k, v in eval_res.items())
    if not (same_ids and len(gathered) == DIST_GROUPS * QUERIES
            and px <= DIST_PX and mgap <= DIST_METRIC):
        bad.append("the gathered eval disagrees with one process's")
    if any(r["eval"] != ranks[0]["eval"] for r in ranks):
        bad.append("the ranks computed different eval metrics")
    # the gathered kernel-path records against the plain path's, by the
    # main path's bounds for that pair (coordinates over the image size)
    d = np.concatenate([
        (np.abs(np.asarray(a["keypoints"])[:, :2]
                - np.asarray(b["keypoints"])[:, :2]) / SIZE).ravel()
        for a, b in zip(gathered, plain_records)]) if gathered else \
        np.asarray([math.inf])
    plain_ids = [r["bbox_id"] for r in gathered] == \
        [r["bbox_id"] for r in plain_records]
    med, within = float(np.median(d)), float(np.mean(d <= PATH_CELL))
    if not (plain_ids and med <= PATH_MEDIAN_TOL
            and within >= PATH_WITHIN_SHARE):
        bad.append("the gathered eval disagrees with the plain path's")
    if os.path.exists(os.path.join(out, "eval1", "result_keypoints.json")):
        bad.append("a rank other than 0 wrote the result file")
    print(f"[dist] {backend} cached eval of {DIST_GROUPS} groups x {QUERIES} "
          f"queries ({DIST_GROUPS // DIST_RANKS} a rank): gathered "
          f"{len(gathered)} records, bbox_ids {'equal' if same_ids else 'DIFFER'}"
          f", keypoints max |d| {px:.3g} px (tol {DIST_PX}), metrics max "
          f"|d| {mgap:.3g} (tol {DIST_METRIC}); PCK {eval_res['PCK']:.4f}; "
          f"vs the plain path (use_flash=False, one process, the same "
          f"chunks): bbox_ids {'equal' if plain_ids else 'DIFFER'}, median "
          f"|d| {med:.4g} (tol {PATH_MEDIAN_TOL}), max {d.max():.4g}, share "
          f"within {PATH_CELL:.4g}: {within:.4f} (tol >= "
          f"{PATH_WITHIN_SHARE})", flush=True)
    train_need = ("fused_vit_block", "flash_mha_train_fwd",
                  "flash_mha_train_bwd")
    eval_need = ("fused_vit_block", "fused_encoder_stack", "flash_mha",
                 "fused_decoder_layer")
    for r in ranks:
        tl, el = r["train_launches"], r["eval_launches"]
        ok = all(tl[k] > 0 for k in train_need) and all(
            el[k] > 0 for k in eval_need)
        print(f"[dist] {backend} rank {r['rank']} launches: training "
              f"{ {k: tl[k] for k in train_need} } (#1, #7, #8), eval "
              f"{ {k: el[k] for k in eval_need} } (#1, #3, #6, #4) "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(f"rank {r['rank']} did not launch every kernel of the "
                       "path")
    if backend == "gloo":
        for k in train_need:
            entries[k]["dist_launches"] = ranks[0]["train_launches"][k]
        for k in eval_need[1:]:
            entries[k]["dist_launches"] = ranks[0]["eval_launches"][k]
        entries["fused_vit_block"]["dist_launches"] += \
            ranks[0]["eval_launches"]["fused_vit_block"]
    if bad:
        fail(f"[dist] {backend}: " + "; ".join(bad))


def dist_path(dev, entries, power):
    """[dist]: DIST_RANKS ranks of the full-width stage-3 model, two
    training steps of the global batch and a sharded cached eval, against
    one process; gloo with both ranks on one card, then NCCL with a card
    a rank where the machine has that many cards."""
    from edgecape_tpu_torch.ops import kernel_config
    n_dev = torch.cuda.device_count()
    print(f"[dist] torch.cuda.device_count() = {n_dev}", flush=True)
    # the ranks' form (the serving phases follow the measured defaults)
    kernel_config.set_decoder_stack(False)
    kernel_config.set_vit_pair_blocks(False)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ref = dist_reference(dev, tmp)
        out, ranks = dist_run("gloo", tmp, power)
        dist_gates("gloo", out, ranks, ref, entries, power)
        if n_dev >= DIST_RANKS:
            out, ranks = dist_run("nccl", tmp, power)
            dist_gates("nccl", out, ranks, ref, entries, power)
        else:
            print(f"[dist] NCCL not measured: {n_dev} device", flush=True)


def stages_path(power):
    """[stages]: tools/profile_eval_stages.py at its full case, every
    stage's device ms; the support and query stages beside the chunk."""
    from edgecape_tpu_torch.tools import profile_eval_stages as PS
    out = PS.main([])
    lost = [r["stage"] for r in out["stages"] if r["clock"] != "device"]
    if lost or out["clock"] != "device" or not out["addmm"]:
        fail(f"[stages] no device time for {lost or 'the addmm sites'}")
    torch.cuda.empty_cache()


def main() -> None:
    tuned_out = None
    if len(sys.argv) == 3 and sys.argv[1] == "--write-tuned":
        tuned_out = sys.argv[2]
    elif len(sys.argv) > 1:
        fail("usage: chip_smoke.py [--write-tuned PATH]")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    power = smi()
    print(power, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    from edgecape_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.lib()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {kernels.build_seconds} s)", flush=True)
    # every phase names the form it drives: the per-layer and per-block
    # forms here, the variants in the variant path, whatever the
    # measured-defaults file says
    from edgecape_tpu_torch.ops import kernel_config
    print(f"[variant] measured-defaults file {kernel_config.tuned_path()}: "
          f"decoder_stack {kernel_config.decoder_stack_default()}, "
          f"vit_pair_blocks {kernel_config.vit_pair_blocks_default()}",
          flush=True)
    kernel_config.set_decoder_stack(False)
    kernel_config.set_vit_pair_blocks(False)
    dev = torch.device("cuda", 0)
    entries = {}
    op_checks(dev, entries)
    train_op_checks(dev, entries)
    attention_checks(dev, entries, power)
    gemm_checks(dev, entries, power)
    torch.cuda.empty_cache()
    est, data, preds, weights = main_path(dev, entries, power)
    width_check(dev, power)
    torch.cuda.empty_cache()
    train_path(dev, entries, power)
    torch.cuda.empty_cache()
    variant_op_checks(dev, entries, power)
    torch.cuda.empty_cache()
    variant_path(dev, entries, power, est, data, preds, tuned_out)
    uncached_path(dev, power, est, weights)
    del est
    torch.cuda.empty_cache()
    bench_tool(entries, power)
    torch.cuda.empty_cache()
    mm_chain_checks(dev, entries, power)
    probe_tool(entries, power)
    torch.cuda.empty_cache()
    disk_path(dev, entries, power)
    torch.cuda.empty_cache()
    serve_op_checks(dev, entries)
    served = serve_path(dev, entries, power)
    router_path(dev, entries, power, served)
    del served
    demo_path(dev, entries, power)
    dist_path(dev, entries, power)
    stages_path(power)
    print(json.dumps({"kernels": finite(list(entries.values()))}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(sys.argv[1:])
    else:
        main()
