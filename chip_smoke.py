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
   (CUDA events, median of several runs);
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
4. prints {"kernels": [...]} on its own line, then the contract line
   {"ok": true, "device": {...}} last.
Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types

import numpy as np
import torch

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
def main_path_config():
    """The stage-3 eval configuration of the main path (the fields of
    edgecape_tpu.config's ModelConfig/DataConfig that the port reads)."""
    model = types.SimpleNamespace(
        backbone_dim=384, image_size=SIZE, patch_size=14, d_model=256,
        nhead=8, num_encoder_layers=3, num_decoder_layers=3,
        dim_feedforward=384, similarity_proj_dim=256, dynamic_proj_dim=128,
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
            print(f"[op] {name}: shape {tuple(out.shape)} max_abs_err "
                  f"{err:.4g} mean_abs_err {mean:.3g} (tol {ATOL} + "
                  f"{RTOL:.4g}*|ref|, mean {MEAN_TOL}; worst excess "
                  f"{excess:.3g}) kernel {ms:.3f} ms plain {plain_ms:.3f} "
                  f"ms {'OK' if ok else 'FAIL'}", flush=True)
            if not ok:
                bad.append(name)
            entries[name] = {"name": name, "route": "cuda",
                             "source": "edgecape_tpu_torch/csrc/kernels.cu",
                             "op": op_src, "replaces": replaces,
                             "launches": 0, "max_abs_err": err, "ms": ms,
                             "plain_ms": plain_ms}
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
    profile(est, data[1], power)


def profile(est, chunk, power):
    """Prints device time by kernel over one warm chunk of the kernel
    path, and the share of the chunk's wall time (forward_cached to
    synchronize) in which the device ran a kernel or a copy: the union of
    those intervals in the profiler's trace."""
    import os
    import tempfile
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    est.forward_cached(chunk[0], chunk[1])
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.forward_cached(chunk[0], chunk[1])
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
    print(f"[profile] one chunk of the kernel path on {power}: wall "
          f"{wall_us / 1e3:.3f} ms (profiler on), {busy}", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=30), flush=True)


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
    torch.cuda.empty_cache()
    main_path(dev, entries, power)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
