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
5. prints {"kernels": [...]} on its own line, then the result line
   {"ok": true, "device": {...}} last.
Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

import json
import math
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

# The card's published peaks (H100 SXM): device memory rate and dense bf16
# tensor-core rate. bound_ms of a kernel is the larger of its bytes (each
# input read once, each output written once) over the first and its
# operations over the second.
PEAK_BYTES_S, PEAK_BF16_FLOPS = 3.35e12, 989e12

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
def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by) of a kernel that must move n_bytes and do
    flops bf16 tensor-core operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def param_bytes(*modules) -> int:
    return sum(nbytes(*m.parameters()) for m in modules)


def main_path_config():
    """The stage-3 eval configuration of the main path (the fields of
    edgecape_tpu.config's ModelConfig/DataConfig that the port reads)."""
    model = types.SimpleNamespace(
        backbone_dim=384, image_size=SIZE, patch_size=14, d_model=256,
        nhead=8, num_encoder_layers=3, num_decoder_layers=3,
        dim_feedforward=384, dropout=0.1, similarity_proj_dim=256, dynamic_proj_dim=128,
        num_feats=128, max_kpt=K, heatmap_size=64, skeleton_num_layers=3,
        use_zero_conv=True, adj_normalization=True, learn_skeleton=True,
        attn_bias=True, max_hops=4, compute_dtype="bfloat16",
        head_dtype="bfloat16", use_flash=True)
    test_data = types.SimpleNamespace(use_udp=False, unbiased_encoding=False,
                                      sigma=1.0)
    return types.SimpleNamespace(model=model, test_data=test_data)


# ------------------------------------------------------------ phase 2
def op_checks(dev, entries):
    import edgecape_tpu_torch.ops.fused_decoder as FD
    import edgecape_tpu_torch.ops.fused_encoder as FE
    import edgecape_tpu_torch.ops.fused_vit_block as FV
    import edgecape_tpu_torch.ops.flash_attention as FA
    from edgecape_tpu_torch.models.dinov2 import VIT_S14, Block
    from edgecape_tpu_torch.models.transformer import (DecoderLayer,
                                                       EncoderLayer)

    g = torch.Generator().manual_seed(SEED)

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    def randomize(module):
        with torch.no_grad():
            for name, p in module.named_parameters():
                if name.endswith(("ls1", "ls2")):
                    p.fill_(1.0)              # every sub-step shows
                elif p.dim() == 2:
                    p.copy_(rn(*p.shape, s=1.0 / math.sqrt(p.shape[1])))
                elif name.endswith("weight"):  # LayerNorm scale
                    p.copy_(1.0 + rn(*p.shape, s=0.1))
                else:
                    p.copy_(rn(*p.shape, s=0.1))
        return module.to(dev).eval()

    nq, hw, c = GROUPS * QUERIES, 256, 256
    bf = torch.bfloat16
    blk = randomize(Block(VIT_S14))
    x = rn(nq, 257, 384).to(bf)
    enc = [randomize(EncoderLayer(c, 8, 384)) for _ in range(3)]
    tok = rn(nq, hw + K, c).to(bf)
    pos = rn(hw + K, c).to(bf)
    valid = torch.rand(nq, hw + K, generator=g).to(dev) > 0.2
    valid[:, :hw] = True
    dec = randomize(DecoderLayer(c, 8, 384, attn_bias=True))
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
            torch.cuda.synchronize()
            d = (out.float() - ref.float()).abs()
            excess = (d - (ATOL + RTOL * ref.float().abs())).max().item()
            err, mean = d.max().item(), d.mean().item()
            ok = excess <= 0 and mean <= MEAN_TOL and bool(
                torch.isfinite(out).all())
            ms, plain_ms = time_ms(kern), time_ms(plain)
            lib_ms = time_ms(library[name]) if name in library else None
            bound_ms, bound_by = bounds[name]
            print(f"[op] {name}: shape {tuple(out.shape)} max_abs_err "
                  f"{err:.4g} mean_abs_err {mean:.3g} (tol {ATOL} + "
                  f"{RTOL:.4g}*|ref|, mean {MEAN_TOL}; worst excess "
                  f"{excess:.3g}) kernel {ms:.3f} ms plain {plain_ms:.3f} "
                  f"ms bound {bound_ms:.4f} ms ({bound_by}) library "
                  f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'} "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append(name)
            entries[name] = {"name": name, "route": "cuda",
                             "source": "edgecape_tpu_torch/csrc/kernels.cu",
                             "op": op_src, "replaces": replaces,
                             "launches": 0, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": lib_ms}
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


def profile(run, what, power):
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
                                    row_limit=30), flush=True)


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
    cfg = main_path_config()
    m = cfg.model
    m.compute_dtype = m.head_dtype = "float32"   # the head trains in fp32
    m.learn_skeleton = m.attn_bias = False
    m.masked_supervision, m.masking_ratio = False, 0.5
    m.use_bias_attn_module, m.model_freeze = False, None
    m.with_heatmap_loss, m.heatmap_loss_weight = False, 2.0
    m.skeleton_loss_weight, m.train_backbone_fast = 1.0, True
    m.dropout = DROPOUT
    cfg.train_data = types.SimpleNamespace(use_udp=False,
                                           unbiased_encoding=False,
                                           sigma=1.0)
    cfg.train = types.SimpleNamespace(
        total_epochs=1, lr=1e-4, warmup_iters=2, warmup_ratio=0.001,
        lr_step=(160, 180), lr_gamma=0.1, batch_size=TRAIN_B,
        eval_interval=1000, ckpt_interval=1000, log_interval=1, seed=SEED,
        grad_clip=None, num_workers=1)
    cfg.work_dir, cfg.load_from, cfg.resume_from = work_dir, None, None
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
    eval loop reads (eval/runner.py): a few one-shot episode groups of
    uint8 images with crop boxes covering the whole image."""
    img_prefix = "."
    name2id = {}

    def __init__(self, rng, groups=4, queries=3):
        self.cfg = types.SimpleNamespace(
            pck_threshold_list=(0.05, 0.1, 0.15, 0.2, 0.25))
        self.rng = rng
        self.queries = queries
        adj = np.zeros((K, K), np.float32)
        for i in range(K - 1):
            adj[i, i + 1] = adj[i + 1, i] = 1.0
        self.adj = adj

        def item():
            return {"joints_3d": np.concatenate(
                        [rng.uniform(8, SIZE - 8, (K, 2)), np.zeros((K, 1))],
                        axis=1).astype(np.float32),
                    "joints_3d_visible": np.ones((K, 3), np.float32),
                    "bbox": np.array([0, 0, SIZE, SIZE], np.float32)}

        self.db, self.paired_samples, self.groups = [], [], []
        for _ in range(groups):
            self.db.append(item())
            sid, rows = len(self.db) - 1, []
            for _ in range(queries):
                self.db.append(item())
                rows.append(len(self.paired_samples))
                self.paired_samples.append([sid, len(self.db) - 1])
            self.groups.append((sid, rows))

    def support_groups(self):
        return self.groups

    def collate_group(self, chunk):
        rng, g = self.rng, len(chunk)
        rows = [r for _, rs in chunk for r in rs]
        nq = len(rows)
        support = {
            "img_s": rng.integers(0, 256, (g, 1, SIZE, SIZE, 3),
                                  dtype=np.uint8),
            "joints_s": np.stack([self.db[sid]["joints_3d"][None, :, :2]
                                  for sid, _ in chunk]),
            "vis_s": np.ones((g, 1, K), np.float32),
            "binary_adj": np.tile(self.adj, (g, 1, 1))}
        query = {"img_q": rng.integers(0, 256, (nq, SIZE, SIZE, 3),
                                       dtype=np.uint8),
                 "group": np.repeat(np.arange(g, dtype=np.int32),
                                    self.queries)}
        meta = {"query_image_file": [f"./q{r}.png" for r in rows],
                "query_center": np.full((nq, 2), SIZE / 2, np.float32),
                "query_scale": np.full((nq, 2), SIZE / 200.0, np.float32),
                "bbox_id": rows}
        return support, query, meta


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


def main() -> None:
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
    dev = torch.device("cuda", 0)
    entries = {}
    op_checks(dev, entries)
    train_op_checks(dev, entries)
    torch.cuda.empty_cache()
    main_path(dev, entries, power)
    torch.cuda.empty_cache()
    train_path(dev, entries, power)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
