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
   output; another seed, another mask;
3. the main path: a stage-3 PoseEstimator (learned skeleton + Markov
   bias, K=100, 224 px, 1 shot, bf16 compute and head dtype, full
   ViT-S/14 width and depth, weights drawn from a seed with the
   zero-initialised parts redrawn) runs the port's depth-2 cached eval
   loop over 3 chunks of 34 episode groups x 15 queries built in memory;
   predictions are decoded on the host and scored (PCK); the launch
   counters must show every kernel op ran as often as the path implies;
   one chunk is compared with the same weights on the plain (no kernel)
   path on the card; one more chunk of the kernel path runs under
   torch.profiler, which gives device time by kernel and the device's
   busy share of that chunk's wall time;
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
   chunk's shapes: fused_ln_mlp and fused_attn_block at [510, 257, 384];
   fused_vit_block2 bit-equal to two fused_vit_block calls (bf16 and fp32
   input) and each of its blocks against the plain block;
   fused_decoder_stack (510 rows, K=100, 256 image tokens, C=256, 3
   layers, Markov bias) layer by layer on the same inputs, then the whole
   stack against the chain of fused_decoder_layer with the glue in
   PyTorch;
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
   the whole output; then the tool itself
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
11. prints {"kernels": [...]} on its own line, then the result line
   {"ok": true, "device": {...}} last.
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
# Uncached and 5-shot episodes: groups, queries per group, batch size.
EVAL_GROUPS, EVAL_QUERIES, EVAL_BATCH = 8, 4, 16
# Strict fp32 on the card against the CPU: fp32 on both sides, summed in
# another order through 12 trunk blocks and the head; TF32 (10 mantissa
# bits) would show as 1e-3 on the trunk's features.
STRICT_MEDIAN, STRICT_P99 = 1e-4, 2e-3

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
             bnd, library=None, counter=None, extra=""):
    """One [op] line and one entry of the kernels line: the kernel's
    output `out` against the plain version's `ref` within ATOL + RTOL *
    |ref| (mean within MEAN_TOL), the times of kern() and plain() and of
    the library call, the bound `bnd`. counter: (module, attribute) of the
    op's launch counter, which one call of kern() must raise by one."""
    per_call = ""
    if counter is not None:
        n0 = getattr(*counter)
        kern()
        n = getattr(*counter) - n0
        per_call = f"; {n} launch counted per call"
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
                     "library_ms": lib_ms}


def main_path_config():
    """The stage-3 eval configuration of the main path: learned skeleton
    and Markov bias, K=100, 224 px, bf16 compute and head dtype."""
    from edgecape_tpu_torch.config import Config, ModelConfig
    return Config(model=ModelConfig(
        image_size=SIZE, max_kpt=K, learn_skeleton=True, attn_bias=True,
        max_hops=4, compute_dtype="bfloat16", head_dtype="bfloat16",
        use_flash=True))


# ------------------------------------------------------------ phase 2
def op_checks(dev, entries):
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    import edgecape_tpu_torch.ops.fused_vit_block as FV
    import edgecape_tpu_torch.ops.flash_attention as FA
    from edgecape_tpu_torch.models.dinov2 import VIT_S14, Block
    from edgecape_tpu_torch.models.transformer import (DecoderLayer,
                                                       EncoderLayer)

    g, rn = seeded_randn(SEED, dev)
    nq, hw, c = GROUPS * QUERIES, 256, 256
    bf = torch.bfloat16
    blk = randomize(Block(VIT_S14), rn, dev)
    x = rn(nq, 257, 384).to(bf)
    enc = [randomize(EncoderLayer(c, 8, 384), rn, dev) for _ in range(3)]
    tok = rn(nq, hw + K, c).to(bf)
    pos = rn(hw + K, c).to(bf)
    valid = torch.rand(nq, hw + K, generator=g).to(dev) > 0.2
    valid[:, :hw] = True
    dec = randomize(DecoderLayer(c, 8, 384, attn_bias=True), rn, dev)
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
    n_tok, c_vit, c_hd, ffn = 257, 384, c, 384
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
    library = {"flash_mha": lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=smask)}

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
        for name, replaces, op_src, kern, plain, pairs in cases:
            out, ref = pairs() if pairs else (kern(), plain())
            check_op(entries, bad, name, replaces, op_src, out, ref, kern,
                     plain, bounds[name], library=library.get(name))
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
    t0 = time.perf_counter()
    timings = run_cached(est, [(i, GROUPS) for i in range(CHUNKS)],
                         lambda i: data[i], on_chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    print(f"[path] launches {counts} expected {expect}", flush=True)
    for name in ("fused_vit_block", "fused_encoder_stack",
                 "fused_decoder_layer", "flash_mha"):
        entries[name]["launches"] = counts[name]
    if counts != expect:
        fail("launch counts differ from what the main path implies")

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
        num = sum(((grads[True][n] - g) ** 2).sum() for n, g in
                  grads[False].items()).sqrt().item()
        den = sum((g ** 2).sum() for g in grads[False].values()).sqrt().item()
        top = max(g.norm().item() for g in grads[False].values())
        worst, worst_name = 0.0, ""
        for n, g in grads[False].items():
            if g.norm().item() >= 1e-3 * top:
                rel = ((grads[True][n] - g).norm() / g.norm()).item()
                if rel > worst:
                    worst, worst_name = rel, n
        ok = num / den <= GRAD_REL_L2 and worst <= GRAD_TENSOR_REL_L2
        print(f"[train] one step's gradients, kernel path vs plain path "
              f"(dropout 0): relative L2 over all {num / den:.4g} (tol "
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
        check_op(entries, bad, "fused_ln_mlp",
                 "edgecape_tpu/ops/fused_mlp.py:67",
                 "edgecape_tpu_torch/ops/fused_mlp.py",
                 FM.fused_ln_mlp(x, *mlp_args),
                 FM.fused_ln_mlp_plain(x, *mlp_args),
                 lambda: FM.fused_ln_mlp(x, *mlp_args),
                 lambda: FM.fused_ln_mlp_plain(x, *mlp_args),
                 bound(xb + nbytes(*mlp_args),
                       2 * nq * n_tok * 8 * c_vit ** 2),
                 counter=(FM, "launches"))
        check_op(entries, bad, "fused_attn_block",
                 "edgecape_tpu/ops/fused_attn_block.py:100",
                 "edgecape_tpu_torch/ops/fused_attn_block.py",
                 FB.fused_attn_block(x, *attn_args, num_heads=6),
                 FB.fused_attn_block_plain(x, *attn_args, num_heads=6),
                 lambda: FB.fused_attn_block(x, *attn_args, num_heads=6),
                 lambda: FB.fused_attn_block_plain(x, *attn_args, num_heads=6),
                 bound(xb + nbytes(*attn_args),
                       2 * nq * n_tok * 4 * c_vit ** 2
                       + 4 * nq * n_tok ** 2 * c_vit),
                 counter=(FB, "launches"))

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
        check_op(entries, bad, "fused_vit_block2",
                 "edgecape_tpu/ops/fused_vit_block.py:248",
                 "edgecape_tpu_torch/ops/fused_vit_block.py", outs, refs,
                 lambda: FV.fused_vit_block2(x, blk_a, blk_b, num_heads=6,
                                             eps=1e-6),
                 lambda: FV.fused_vit_block2_plain(x, blk_a, blk_b,
                                                   num_heads=6, eps=1e-6),
                 bound(xb + param_bytes(blk_a, blk_b),
                       2 * (2 * nq * n_tok * 12 * c_vit ** 2
                            + 4 * nq * n_tok ** 2 * c_vit)),
                 counter=(FV, "launches2"),
                 extra=f"; one fused_vit_block {one_ms:.3f} ms")

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
        print(f"[op] fused_decoder_stack: {layers} layers, rows {nq}, K {K}, "
              f"HW {hw}, C {c}, Markov bias from the hop stack in the "
              f"kernel: {one_call} launch count per call, whole stack vs "
              f"plain max_abs_err {err:.4g} (information: ulp differences "
              f"grow through the layers; the bound is on each layer alone, "
              f"worst {worst:.4g}, tol {STACK_LAYER_MAX}) kernel {ms:.3f} ms "
              f"plain {plain_ms:.3f} ms chain of fused_decoder_layer with "
              f"PyTorch glue {chain_ms:.3f} ms bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) library none", flush=True)
        entries["fused_decoder_stack"] = {
            "name": "fused_decoder_stack", "route": "cuda",
            "source": "edgecape_tpu_torch/csrc/kernels.cu",
            "op": "edgecape_tpu_torch/ops/fused_decoder.py",
            "replaces": "edgecape_tpu/ops/fused_decoder.py:531",
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "chain_ms": chain_ms}
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
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_vit_block as FV

    nq = GROUPS * QUERIES
    chunks = [(i, GROUPS) for i in range(CHUNKS)]

    def run(stack, pair):
        KC.set_decoder_stack(stack)
        KC.set_vit_pair_blocks(pair)
        preds = []
        FV.launches = FV.launches2 = FD.launches = FD.stack_launches = 0
        t0 = time.perf_counter()
        run_cached(est, chunks, lambda i: data[i],
                   lambda pred, *a: preds.append(pred))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"fused_vit_block": FV.launches,
                  "fused_vit_block2": FV.launches2,
                  "fused_decoder_layer": FD.launches,
                  "fused_decoder_stack": FD.stack_launches}
        return preds, wall, counts

    try:
        run(True, True)                      # warm-up of the variant ops
        preds, wall, counts = run(True, True)
        expect = {"fused_vit_block": 0, "fused_vit_block2": 12 * CHUNKS,
                  "fused_decoder_layer": 0, "fused_decoder_stack": CHUNKS}
        print(f"[variant] both switches on: launches {counts} expected "
              f"{expect} ({CHUNKS} chunks: per chunk 12 fused_vit_block2 "
              f"over the two backbone passes and 1 fused_decoder_stack)",
              flush=True)
        if counts != expect:
            fail("variant path launch counts differ from what it implies")
        for name in ("fused_vit_block2", "fused_decoder_stack"):
            entries[name]["launches"] = counts[name]
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
def mm_chain_checks(dev, entries, power):
    """ops.mm_chain against mm_chain_plain at a small shape and the probe
    tool's three cases, `loop` and `fold`."""
    import edgecape_tpu_torch.ops.mm_chain as MC
    from edgecape_tpu_torch.tools import probe_m_fold as P

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
        flops = 4.0 * b * n * c * f * reps
        bnd = bound(nbytes(x, x, w1, w2), flops)
        print(f"[op] mm_chain {label}: shape {tuple(ref.shape)} max_abs_err "
              f"{err:.4g} (tol {MM_MAX_REL:.4g} * max|ref| = "
              f"{MM_MAX_REL * top:.4g}) mean_abs_err {mean:.4g} (tol "
              f"{MM_MEAN_REL} * mean|ref| = {MM_MEAN_REL * mean_mag:.4g}) "
              f"loop == fold bit for bit: {bitsame}; kernel loop "
              f"{ms[False]:.3f} ms ({flops / ms[False] / 1e9:.1f} TFLOP/s) "
              f"fold {ms[True]:.3f} ms ({flops / ms[True] / 1e9:.1f} "
              f"TFLOP/s) plain {plain_ms:.3f} ms bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) library none; {counted} launches counted for two "
              f"calls on {power} {'OK' if ok else 'FAIL'}", flush=True)
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
                "library_ms": None}
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
            if steps < 4 or got["fused_vit_block"] != 12 * steps or \
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
    torch.cuda.empty_cache()
    est, data, preds, weights = main_path(dev, entries, power)
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
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
