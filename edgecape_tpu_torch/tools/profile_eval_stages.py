"""Time per stage of the cached eval chunk; counterpart of
scripts/profile_eval_stages.py.

    python -m edgecape_tpu_torch.tools.profile_eval_stages [--tuned]
    python -m edgecape_tpu_torch.tools.profile_eval_stages --device cpu \\
        --case 2,3,6,28

The main path's chunk: the stage-3 model (learned skeleton, Markov bias),
bf16 compute and head dtype, full ViT-S/14 and head widths, seeded random
weights, G 34 episode groups x 15 queries, K 100, 224 px. Its stages, as
the JAX script cuts them: the backbone alone on the 510 query images, the
support phase (34 groups: trunk, heatmap pooling, skeleton), the query
phase (510 rows: trunk, encoder, proposals, decoder), the head alone
(encoder + decoder + glue on ready features), the query encoder alone,
the 3 encoder layers' kernels alone (#3, fused_encoder_stack), the 3
decoder layers' kernels alone (#4, fused_decoder_layer, zero bias as in
the JAX script), and the whole chunk (forward_cached from host arrays,
the copies included). The variant switches are pinned off, as on the
main path (`--tuned` keeps the measured-defaults file's).

On the card each stage's time is the device time of its kernels and
copies per call, from a profiler trace in which they are matched to the
calls by correlation id (tools/bench_attention.device_ms); where no trace
holds whole device events the line says "device not measured" beside the
CUDA-event wall time. Then one chunk runs under the profiler with a
record_function range around every module's forward, and its eager
`aten::addmm` time is attributed to the module that issued it ("outside
the modules": a functional call, such as the fused trunk's patch
embedding). With `--device cpu` (for the tests) each stage is timed on
the host (one call) and the attribution is by host time; `--case
g,q,k,size` cuts the chunk (groups, queries per group, keypoints, image
size).
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np
import torch

FULL_CASE = (34, 15, 100, 224)
REPS = 3          # traced calls per stage on the card


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.tools.profile_eval_stages",
        description="Time per stage of the cached eval chunk")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--case", default=None,
                   help="groups,queries,keypoints,image_size (default "
                   "34,15,100,224)")
    p.add_argument("--tuned", action="store_true",
                   help="keep the variant switches of the measured-"
                   "defaults file (default: both off, as the main path)")
    p.add_argument("--top", type=int, default=12,
                   help="aten::addmm call sites to print")
    return p.parse_args(argv)


def chunk(rng, g: int, q: int, k: int, size: int):
    """One chunk in memory: (support, query) as forward_cached takes them,
    uint8 images, a chain skeleton, some keypoints invisible."""
    adj = np.zeros((k, k), np.float32)
    for i in range(k - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1.0
    support = {
        "img_s": rng.integers(0, 256, (g, 1, size, size, 3), dtype=np.uint8),
        "joints_s": rng.uniform(2, size - 2, (g, 1, k, 2)).astype(np.float32),
        "vis_s": (rng.uniform(size=(g, 1, k)) > 0.1).astype(np.float32),
        "binary_adj": np.tile(adj, (g, 1, 1))}
    query = {"img_q": rng.integers(0, 256, (g * q, size, size, 3),
                                   dtype=np.uint8),
             "group": np.repeat(np.arange(g, dtype=np.int32), q)}
    return support, query


def estimator(case, device, seed: int = 0):
    """The stage-3 bf16 estimator at full widths, seeded random weights
    with the zero-initialised parts redrawn."""
    from ..api import PoseEstimator
    from ..config import Config, ModelConfig
    from ..models.convert import init_params, redraw_zero_inits
    _, _, k, size = case
    cfg = Config(model=ModelConfig(
        image_size=size, max_kpt=k, heatmap_size=max(8, 64 * size // 224),
        learn_skeleton=True, attn_bias=True, max_hops=4,
        compute_dtype="bfloat16", head_dtype="bfloat16", use_flash=True))
    gen = torch.Generator().manual_seed(seed)
    bb, head = init_params(gen, cfg.model)
    redraw_zero_inits(bb, head, gen)
    return PoseEstimator(cfg, bb, head, device=device)


def stages(est, support, query):
    """[(stage name, fn)], every fn a call of the stage on inputs already
    on the estimator's device (the whole chunk from host arrays)."""
    from ..api import SupportContext, _cast_floats, maybe_normalize
    from ..models import dinov2
    from ..ops.fused_decoder import fused_decoder_layer
    from ..ops.fused_encoder import fused_encoder_stack
    dev = est.device
    t = {k: torch.from_numpy(np.asarray(v)).to(dev)
         for k, v in {**support, **query}.items()}
    img_q = maybe_normalize(t["img_q"])
    group = t["group"].long()
    head = est.query_head
    hd = est.head_dtype
    m = est.cfg.model
    with torch.no_grad():
        ctx = est.support_context(t["img_s"], t["joints_s"], t["vis_s"],
                                  t["binary_adj"])
        ctx_rows = _cast_floats(SupportContext(
            *(None if a is None else a[group] for a in ctx)), hd)
        feat_q = dinov2.extract_features(
            est.backbone, img_q, dtype=est.compute_dtype,
            use_flash=est.use_flash).to(hd)
        enc = head.encode_query(feat_q, ctx_rows)
    nq, k, c = enc.kp_tokens.shape
    hw = enc.img_tokens.shape[1]
    rng = torch.Generator().manual_seed(1)

    def rn(*shape):
        return torch.randn(*shape, generator=rng).to(dev, hd)

    tokens = rn(nq, hw + k, c)
    pos = rn(hw + k, c)
    valid = torch.ones(nq, hw + k, dtype=torch.bool, device=dev)
    qpos = rn(nq, k, c)
    bias0 = torch.zeros(nq, m.nhead, k, k, device=dev)

    def backbone():
        return dinov2.extract_features(est.backbone, img_q,
                                       dtype=est.compute_dtype,
                                       use_flash=est.use_flash)

    def support_phase():
        return est.support_context(t["img_s"], t["joints_s"], t["vis_s"],
                                   t["binary_adj"])

    def query_phase():
        rows = SupportContext(*(None if a is None else a[group]
                                for a in ctx))
        return est.query_rows(rows, img_q)

    def head_only():
        e = head.encode_query(feat_q, ctx_rows)
        return head.decode(e.kp_tokens, e.img_tokens, e.proposals, e.adj,
                           e.hop_stack, e.kp_valid, e.img_pos)[0]

    def encoder():
        return head.encode_query(feat_q, ctx_rows).kp_tokens

    def encoder_kernels():
        return fused_encoder_stack(tokens, pos, valid, head.encoder_layers,
                                   num_heads=m.nhead, eps=1e-5)

    def decoder_kernels():
        x = enc.kp_tokens
        for layer in head.decoder.layers:
            x = fused_decoder_layer(x, qpos, enc.img_tokens, enc.img_pos[0],
                                    enc.kp_valid, bias0, enc.adj, layer,
                                    num_heads=m.nhead, eps=1e-5)
        return x

    def combined():
        return est.forward_cached(support, query)[0]

    g = support["img_s"].shape[0]
    return [(f"backbone ({nq} queries)", backbone),
            (f"support ({g} groups)", support_phase),
            (f"query ({nq})", query_phase),
            ("head (encoder + decoder + glue)", head_only),
            (f"encode_query ({nq})", encoder),
            (f"{len(head.encoder_layers)} x encoder kernels (#3)",
             encoder_kernels),
            (f"{len(head.decoder.layers)} x decoder kernels (#4)",
             decoder_kernels),
            ("combined (chunk)", combined)]


def _no_grad(fn):
    def run():
        with torch.no_grad():
            return fn()
    return run


def time_stage(fn, on_card: bool) -> dict:
    """{"ms", "kernels", "clock"}: device ms per call (clock "device"), or
    the CUDA-event wall ms when no trace was whole ("wall"), or the host
    ms of one call on the CPU ("host")."""
    fn = _no_grad(fn)
    if on_card:
        from .bench_attention import device_ms
        dev, n, wall = device_ms(fn, REPS)
        if dev is not None:
            return {"ms": dev, "kernels": n, "clock": "device"}
        return {"ms": wall, "kernels": None, "clock": "wall"}
    from ..utils.profiling import synced_time
    return {"ms": synced_time(fn, iters=1, warmup=0) * 1e3, "kernels": None,
            "clock": "host"}


def _site(evt, labels) -> str:
    """The innermost module whose forward issued a profiler event (the
    record_function ranges of `module_ranges`, by their labels), the
    layers of a stack as one site (decoder.layers.*.bias_mlp.fc1)."""
    p = evt.cpu_parent
    while p is not None and p.name not in labels:
        p = p.cpu_parent
    if p is None:
        return "outside the modules"
    return re.sub(r"\.\d+(?=\.|$)", ".*", p.name)


def module_ranges(named_roots) -> tuple:
    """Hooks that open a torch.profiler.record_function range named
    `root.sub.module` around every submodule's forward, so that a
    profiler event can be traced to the module that issued it; returns
    (the hooks' handles, the labels)."""
    from torch.profiler import record_function
    open_ranges, handles, labels = [], [], set()
    for prefix, root in named_roots:
        for name, mod in root.named_modules():
            label = f"{prefix}.{name}" if name else prefix
            labels.add(label)

            def pre(m, args, label=label):
                rng = record_function(label)
                rng.__enter__()
                open_ranges.append(rng)

            def post(m, args, out):
                open_ranges.pop().__exit__(None, None, None)

            handles += [mod.register_forward_pre_hook(pre),
                        mod.register_forward_hook(post)]
    return handles, labels


def addmm_sites(fn, on_card: bool, top: int, modules) -> list:
    """[(ms, calls, site)] of the aten::addmm issued by one call of fn,
    by the module that issued it: device ms on the card, host ms on the
    CPU; the largest first. modules: [(label, module)] to attribute to."""
    from torch.profiler import ProfilerActivity, profile
    fn = _no_grad(fn)
    fn()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    handles, labels = module_ranges(modules)
    try:
        with profile(activities=acts) as prof:
            fn()
            if on_card:
                torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    sites = {}
    for evt in prof.events():
        if evt.name != "aten::addmm":
            continue
        us = evt.device_time_total if on_card else evt.cpu_time_total
        site = _site(evt, labels)
        ms, n = sites.get(site, (0.0, 0))
        sites[site] = (ms + us / 1e3, n + 1)
    rows = sorted(((ms, n, s) for s, (ms, n) in sites.items()), reverse=True)
    return rows[:top] + ([(sum(r[0] for r in rows[top:]),
                           sum(r[1] for r in rows[top:]), "other sites")]
                         if len(rows) > top else [])


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..api import resolve_device
    from ..ops import kernel_config
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    case = FULL_CASE if args.case is None else tuple(
        int(v) for v in args.case.split(","))
    if not args.tuned:
        kernel_config.set_decoder_stack(False)
        kernel_config.set_vit_pair_blocks(False)
    where = device.type
    if on_card:
        from .bench_attn_variants import card
        where = card()
    g, q, k, size = case
    est = estimator(case, device)
    support, query = chunk(np.random.default_rng(0), g, q, k, size)
    print(f"[stages] cached chunk of {g} groups x {q} queries, K {k}, "
          f"{size} px, stage 3, bf16, decoder_stack "
          f"{kernel_config.decoder_stack_default()}, vit_pair_blocks "
          f"{kernel_config.vit_pair_blocks_default()}, on {where}",
          flush=True)
    rows = []
    t0 = time.perf_counter()
    for name, fn in stages(est, support, query):
        r = time_stage(fn, on_card)
        r["stage"] = name
        rows.append(r)
        what = {"device": "device", "wall": "device not measured; wall",
                "host": "host"}[r["clock"]]
        kern = "" if r["kernels"] is None else \
            f" in {r['kernels']} kernels and copies"
        print(f"[stages] {name:34s} {what} {r['ms']:9.3f} ms{kern}",
              flush=True)
    by = {r["stage"]: r["ms"] for r in rows}
    parts = rows[1]["ms"] + rows[2]["ms"]
    print(f"[stages] support + query {parts:.3f} ms against the combined "
          f"chunk {by['combined (chunk)']:.3f} ms ({rows[-1]['clock']} "
          f"time; the chunk adds the host-to-device copies)", flush=True)
    modules = [("backbone", est.backbone), ("head", est.head)]
    if est.query_head is not est.head:
        modules.append(("query_head", est.query_head))
    sites = addmm_sites(stages(est, support, query)[-1][1], on_card,
                        args.top, modules)
    clock = "device" if on_card else "host"
    total = sum(ms for ms, _, _ in sites)
    print(f"[stages] aten::addmm in one chunk: {total:.3f} ms of {clock} "
          f"time in {sum(n for _, n, _ in sites)} calls, by call site:",
          flush=True)
    for ms, n, site in sites:
        print(f"[stages]   {ms:8.3f} ms {n:5d} calls  {site}", flush=True)
    print(f"[stages] {time.perf_counter() - t0:.1f} s", flush=True)
    return {"stages": rows, "addmm": sites, "clock": clock, "case": case}


if __name__ == "__main__":
    main(sys.argv[1:])
