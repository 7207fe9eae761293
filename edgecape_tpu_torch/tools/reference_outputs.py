"""The stage-3 model's outputs at its reference widths (d_model 256 in 8
heads, FFN 384, K 100, 224 px, bf16, seeded weights and episodes), for
holding two checkouts of the port against each other bit for bit on the
card:

* one cached eval chunk of 34 groups x 15 queries with the decoder stack
  off, then on (510 x 100 x 2 coordinates each), with the kernels each
  launched;
* flash_mha_train on [16, 356, 8, 32] fp32 operands with a key mask at
  dropout 0.1 (the training step's encoder shape): its output and the
  gradients of q, k and v;
* with --wide, vit_ln_gemm (the wide route's LayerNorm + projection) at
  ViT-B/14's and ViT-L/14's qkv and fc1 widths (WIDE_CASES: fp32 and bf16
  x, both W layouts, the support pass's rows), its bf16 bits as int16;
* with --heads, the wide head kernels (the decoder kernels of
  csrc/dec_self_wide.cu and dec_wide.cu through dec_post_self /
  dec_post_cross, csrc/kpt_wide.cu's through kpt_head, csrc/head_wide.cu's
  through enc_post and bias_attention) at HEAD_CASES' widths,
  60 batch rows of K keypoints (enc_post: of 356 tokens), seeded
  DecoderLayer / EncoderLayer weights: their outputs, each kernel's
  arrays named apart (heads_<C>_x1 / _q2 / _out, _pts / _outs, _enc_y /
  _enc_nxt, _bias), so that a comparison shows which kernels kept their
  bits;
* with --kpts, the bias attention above 128 keypoints (ops/kernels.py
  bias_attention: csrc/bias_long.cu) at KPTS_KEYS keypoints and
  KPTS_CASES' heads (8 of 32, 8 of 64), KPTS_ROWS seeded batch rows with
  a key mask: its bf16 bits as int16, kpts_<K>_<C> an array;
* with --long, the streaming attention kernels (csrc/attn_long.cu) at
  head dims 32 and 64 on LONG_CASES' 518 px shapes: attention's bf16
  bits as int16 (long_<name>), and for the training cases
  flash_mha_train's output and the gradients of q, k, v and the bias at
  dropout 0.1 (long_<name>_out / _dq / _dk / _dv / _dbias);
* with --split, the stage-3 model with the heads of SPLIT_CASES (768 / 12
  and 1024 / 16, the split route above 512 channels) over the same
  trunk: one cached chunk of SPLIT_GROUPS groups x 15 queries with the
  decoder stack off, then on (split_<C>_stack_<on>), with the kernels each
  launched.

    python edgecape_tpu_torch/tools/reference_outputs.py [--root DIR]
        [--wide] [--heads] [--kpts] [--long] [--split] OUT.npz
    python edgecape_tpu_torch/tools/reference_outputs.py --compare A.npz B.npz

--root runs the package of another checkout (the parent's, unpacked from
`git archive`), with this script. --compare prints, array by array,
whether the two files are bit-equal (and the largest difference where
not), and exits 1 unless every array and every launch count is equal.
Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

GROUPS, QUERIES, K, SIZE, SEED = 34, 15, 100, 224, 0
TRAIN_SHAPE, RATE = (16, 356, 8, 32), 0.1
# name, rows, C, N, x fp32 (rounded to bf16 before the LayerNorm) or bf16,
# W [N, C] (else [C, N]), GELU
WIDE_CASES = (("qkv_b", 2000, 768, 2304, True, True, False),
              ("fc1_b", 2000, 768, 3072, False, False, True),
              ("qkv_l", 1000, 1024, 3072, True, False, False),
              ("fc1_l", 1000, 1024, 4096, False, True, True),
              ("qkv_b_support", 34 * 257, 768, 2304, True, True, False))


# (d_model, heads, FFN) of the --heads cases, and their batch rows
HEAD_CASES, HEAD_ROWS = ((200, 8, 300), (512, 8, 1024)), 60
# (d_model, heads), keypoints and batch rows of the --kpts cases
KPTS_CASES, KPTS_KEYS, KPTS_ROWS = ((256, 8), (512, 8)), (133, 256, 300), 60
# (d_model, heads, FFN) of the --split cases, and their chunk's groups
SPLIT_CASES, SPLIT_GROUPS = ((768, 12, 1536), (1024, 16, 2048)), 4


def _episodes(rng, groups=GROUPS):
    """One chunk of `groups` x QUERIES uint8 episodes, a chain skeleton."""
    adj = np.zeros((K, K), np.float32)
    for i in range(K - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1.0
    vis = (rng.uniform(size=(groups, 1, K)) > 0.1).astype(np.float32)
    support = {
        "img_s": rng.integers(0, 256, (groups, 1, SIZE, SIZE, 3),
                              dtype=np.uint8),
        "joints_s": rng.uniform(8, SIZE - 8, (groups, 1, K, 2)).astype(
            np.float32),
        "vis_s": vis, "binary_adj": np.tile(adj, (groups, 1, 1))}
    query = {"img_q": rng.integers(0, 256, (groups * QUERIES, SIZE, SIZE, 3),
                                   dtype=np.uint8),
             "group": np.repeat(np.arange(groups, dtype=np.int32), QUERIES)}
    return support, query


def _wide(dev, arrays, launches) -> None:
    """vit_ln_gemm at WIDE_CASES, seeded, into arrays (bits as int16)."""
    import torch
    from edgecape_tpu_torch.ops import kernels as KN
    g = torch.Generator().manual_seed(SEED + 3)
    n0 = KN.launches["vit_ln_gemm_kernel"]
    for name, r, c, n, f32, b_nk, gelu in WIDE_CASES:
        x = torch.randn(r, c, generator=g).to(dev)
        x = x if f32 else x.to(torch.bfloat16)
        gam = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        bet = (0.1 * torch.randn(c, generator=g)).to(dev)
        w = (torch.randn(n, c, generator=g) * c ** -0.5).to(dev).to(
            torch.bfloat16)
        bias = (0.1 * torch.randn(n, generator=g)).to(dev)
        out = KN.vit_ln_gemm(x, gam, bet, w if b_nk else w.t().contiguous(),
                             bias, eps=1e-6, b_nk=b_nk, gelu=gelu,
                             round_in=f32)
        arrays[f"wide_{name}"] = out.view(torch.int16).cpu().numpy()
    launches["wide"] = {"vit_ln_gemm_kernel":
                        KN.launches["vit_ln_gemm_kernel"] - n0}


def _heads(dev, arrays, launches) -> None:
    """dec_post_self, dec_post_cross, kpt_head, enc_post and
    bias_attention at HEAD_CASES (their wide kernels), seeded, into arrays
    (bf16 bits as int16). Launches are read with a default of 0, so that
    a checkout without one of the kernels runs the same script."""
    import torch
    from edgecape_tpu_torch.models.transformer import (DecoderLayer,
                                                       EncoderLayer)
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import fused_encoder as FE
    from edgecape_tpu_torch.ops import kernels as KN
    names = ("dec_post_self_wide_kernel", "dec_post_cross_wide_kernel",
             "dec_post_gcn_wide_kernel", "kpt_head_wide_kernel",
             "enc_post_wide_kernel", "bias_attn_wide_kernel")
    n0 = {n: KN.launches.get(n, 0) for n in names}
    g = torch.Generator().manual_seed(SEED + 4)
    bf, b = torch.bfloat16, HEAD_ROWS

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    def bits(t):
        return t.view(torch.int16).cpu().numpy()

    def seeded(layer):
        with torch.no_grad():
            for name, p in layer.named_parameters():
                if p.dim() == 2:
                    p.copy_(torch.randn(p.shape, generator=g)
                            * p.shape[1] ** -0.5)
                else:
                    p.copy_(0.1 * torch.randn(p.shape, generator=g)
                            + (1.0 if name.endswith("weight") else 0.0))
        return layer.to(dev).eval()
    for c, h, f in HEAD_CASES:
        w = FD._prepare(seeded(DecoderLayer(c, h, f)))
        r = b * K
        x1, q2 = KN.dec_post_self(rn(r, c).to(bf), rn(r, c).to(bf),
                                  rn(r, c).to(bf), w, eps=1e-5)
        adj = (torch.rand(b, 2, K, K, generator=g) / K).to(dev)
        y = KN.dec_post_cross(rn(b, K, 2 * c).to(bf), x1, adj, w, eps=1e-5,
                              out_dtype=bf)
        cp = KN.kpt_head_plan(r, c)["c_pad"]
        kpt = [(KN.pad_cols(rn(c, c, s=c ** -0.5), cp, cp).to(bf)
                .contiguous(), rn(c, s=0.1)) for _ in range(3)]
        fn = (1.0 + rn(c, s=0.1), rn(c, s=0.1))
        x, ct = rn(r, c).to(bf), torch.rand(r, 2, generator=g).to(dev)
        pts, outs = torch.empty_like(ct), torch.empty_like(ct)
        KN.kpt_head(x, ct, fn, kpt, rn(2, c, s=0.02).to(bf), rn(2, s=0.02),
                    pts, outs, eps=1e-5)
        we = FE._prepare(seeded(EncoderLayer(c, h, f)))
        re = b * 356
        enc_y, enc_nxt = KN.enc_post(rn(re, c).to(bf), rn(re, c).to(bf), we,
                                     eps=1e-5, out_dtype=bf,
                                     pos=rn(356, c).to(bf))
        hid = 4 + h
        mlp = (rn(5, hid), rn(hid, s=0.1), rn(hid, h, s=hid ** -0.5),
               rn(h, s=0.1))
        valid = torch.rand(b, K, generator=g).to(dev) > 0.3
        valid[:, 0] = True
        att = KN.bias_attention(
            rn(b, K, 3 * c).to(bf), valid,
            torch.rand(b, K, K, 5, generator=g).to(dev).to(bf), mlp,
            num_heads=h)
        arrays.update({f"heads_{c}_x1": x1.cpu().numpy(),
                       f"heads_{c}_q2": bits(q2), f"heads_{c}_out": bits(y),
                       f"heads_{c}_pts": pts.cpu().numpy(),
                       f"heads_{c}_outs": outs.cpu().numpy(),
                       f"heads_{c}_enc_y": bits(enc_y),
                       f"heads_{c}_enc_nxt": bits(enc_nxt),
                       f"heads_{c}_bias": bits(att)})
    launches["heads"] = {n: KN.launches.get(n, 0) - n0[n] for n in names}


def _kpts(dev, arrays, launches) -> None:
    """bias_attention at KPTS_CASES x KPTS_KEYS, seeded (5 hop planes, 12
    hidden units, about 30% of the keys masked), into arrays (bf16 bits as
    int16). Launches are read with a default of 0, so that a checkout
    without one of the kernels runs the same script."""
    import torch
    from edgecape_tpu_torch.ops import kernels as KN
    names = ("bias_attn_long_kernel",)
    n0 = {n: KN.launches.get(n, 0) for n in names}
    g = torch.Generator().manual_seed(SEED + 5)
    b = KPTS_ROWS
    for c, h in KPTS_CASES:
        for k in KPTS_KEYS:
            qkv = torch.randn(b, k, 3 * c, generator=g).to(dev).to(
                torch.bfloat16)
            valid = torch.rand(b, k, generator=g).to(dev) > 0.3
            valid[:, 0] = True
            hops = torch.rand(b, k, k, 5, generator=g).to(dev).to(
                torch.bfloat16)
            mlp = tuple(t.to(dev) for t in (
                torch.randn(5, 12, generator=g),
                torch.randn(12, generator=g) * 0.1,
                torch.randn(12, h, generator=g) * 12 ** -0.5,
                torch.randn(h, generator=g) * 0.1))
            att = KN.bias_attention(qkv, valid, hops, mlp, num_heads=h)
            arrays[f"kpts_{k}_{c}"] = att.view(torch.int16).cpu().numpy()
    launches["kpts"] = {n: KN.launches.get(n, 0) - n0[n] for n in names}


# name, batch, queries, keys, heads, head dim, key mask, training (with
# a bias) of the --long cases: the 518 px ViT, joint encoder and decoder
# cross-attention at head dims 64 and 32, and training rows at both
LONG_CASES = (("vit", 4, 1370, 1370, 6, 64, False, False),
              ("encoder", 4, 1469, 1469, 8, 32, True, False),
              ("cross", 8, 100, 1369, 8, 64, False, False),
              ("train32", 2, 1469, 1469, 8, 32, True, True),
              ("train64", 2, 600, 600, 4, 64, True, True))


def _long(dev, arrays, launches) -> None:
    """The streaming kernels at LONG_CASES (operands seeded, about 20% of
    the keys masked), into arrays. Launches are read with a default of 0,
    as _kpts reads them."""
    import torch
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as KN
    names = ("attn_long_kernel", "train_fwd_long_kernel",
             "train_bwd_q_long_kernel", "train_bwd_k_long_kernel")
    n0 = {n: KN.launches.get(n, 0) for n in names}
    g = torch.Generator().manual_seed(SEED + 6)
    for name, b, nq, nk, h, d, masked, train in LONG_CASES:
        q = torch.randn(b, nq, h, d, generator=g).to(dev)
        k, v = (torch.randn(b, nk, h, d, generator=g).to(dev)
                for _ in range(2))
        valid = None
        if masked:
            valid = (torch.rand(b, nk, generator=g) > 0.2).to(dev)
            valid[:, 0] = True
        if not train:
            att = KN.attention(*(t.reshape(t.shape[0], t.shape[1], h * d)
                                 .to(torch.bfloat16) for t in (q, k, v)),
                               num_heads=h, scale=d ** -0.5, key_valid=valid)
            arrays[f"long_{name}"] = att.view(torch.int16).cpu().numpy()
            continue
        bias = (0.3 * torch.randn(b, h, nq, nk, generator=g)).to(dev)
        go = torch.randn(b, nq, h, d, generator=g).to(dev)
        leaves = [t.requires_grad_(True) for t in (q, k, v, bias)]
        out = FA.flash_mha_train(
            *leaves[:3], valid, leaves[3], dropout_rate=RATE,
            generator=torch.Generator(device=dev).manual_seed(SEED + 7))
        grads = torch.autograd.grad(out, leaves, go)
        arrays[f"long_{name}_out"] = out.detach().cpu().numpy()
        for part, t in zip(("dq", "dk", "dv", "dbias"), grads):
            arrays[f"long_{name}_{part}"] = t.cpu().numpy()
    launches["long"] = {n: KN.launches.get(n, 0) - n0[n] for n in names}


def _chunks(dev, cfg, seed, groups, name, arrays, launches) -> None:
    """One cached chunk of the model `cfg` (seeded weights, `groups` x
    QUERIES episodes) with the decoder stack off, then on: its predictions
    and the kernels it launched, under `name`_stack_<on>."""
    import torch
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.models.convert import (init_params,
                                                   redraw_zero_inits)
    from edgecape_tpu_torch.ops import counters, kernel_config
    gen = torch.Generator().manual_seed(seed)
    bb, head = init_params(gen, cfg.model)
    redraw_zero_inits(bb, head, gen)
    support, query = _episodes(np.random.default_rng(seed), groups)
    kernel_config.set_vit_pair_blocks(False)
    for stack in (False, True):
        kernel_config.set_decoder_stack(stack)
        est = PoseEstimator(cfg, bb, head, device=dev)
        est.forward_cached(support, query)                  # warm-up
        torch.cuda.synchronize()
        counters.zero_counts()
        pred = est.forward_cached(support, query)[0]
        torch.cuda.synchronize()
        arrays[f"{name}_stack_{stack}"] = pred.cpu().numpy()
        launches[f"{name}_stack_{stack}"] = \
            counters.launch_counts()["kernels"]
        del est


def _split(dev, cfg, arrays, launches) -> None:
    """The model at SPLIT_CASES' head widths (cfg's otherwise), its
    chunks into arrays (split_<C>_stack_<on>)."""
    import dataclasses
    for c, h, f in SPLIT_CASES:
        model = dataclasses.replace(cfg.model, d_model=c, nhead=h,
                                    dim_feedforward=f, num_feats=c // 2,
                                    similarity_proj_dim=c)
        _chunks(dev, dataclasses.replace(cfg, model=model), SEED + 8 + c,
                SPLIT_GROUPS, f"split_{c}", arrays, launches)


def run(root: str, out: str, wide: bool = False, heads: bool = False,
        kpts: bool = False, long: bool = False,
        split: bool = False) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from edgecape_tpu_torch.config import Config, ModelConfig
    from edgecape_tpu_torch.ops import flash_attention as FA
    if not torch.cuda.is_available():
        raise SystemExit("reference_outputs needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = Config(model=ModelConfig(
        image_size=SIZE, max_kpt=K, learn_skeleton=True, attn_bias=True,
        max_hops=4, compute_dtype="bfloat16", head_dtype="bfloat16",
        use_flash=True))
    arrays, launches = {}, {}
    _chunks(dev, cfg, SEED, GROUPS, "preds", arrays, launches)
    for stack in (False, True):       # the names of the earlier files
        launches[f"stack_{stack}"] = launches.pop(f"preds_stack_{stack}")
    g = torch.Generator().manual_seed(SEED + 1)
    q, k, v, go = (torch.randn(*TRAIN_SHAPE, generator=g).to(dev)
                   for _ in range(4))
    valid = (torch.rand(TRAIN_SHAPE[0], TRAIN_SHAPE[1], generator=g)
             > 0.2).to(dev)
    valid[:, 0] = True
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    att = FA.flash_mha_train(
        *leaves, valid, None, dropout_rate=RATE,
        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    grads = torch.autograd.grad(att, leaves, go)
    arrays["train_out"] = att.detach().cpu().numpy()
    for name, t in zip(("dq", "dk", "dv"), grads):
        arrays[f"train_{name}"] = t.cpu().numpy()
    if wide:
        _wide(dev, arrays, launches)
    if heads:
        _heads(dev, arrays, launches)
    if kpts:
        _kpts(dev, arrays, launches)
    if long:
        _long(dev, arrays, launches)
    if split:
        _split(dev, cfg, arrays, launches)
    np.savez(out, launches=json.dumps(launches, sort_keys=True),
             device=torch.cuda.get_device_name(0), **arrays)
    print(f"wrote {out}: {sorted(arrays)} on {torch.cuda.get_device_name(0)}"
          f"; launches {json.dumps(launches, sort_keys=True)}")


def compare(a_path: str, b_path: str) -> bool:
    a, b = np.load(a_path), np.load(b_path)
    same = True
    for name in sorted(set(a.files) | set(b.files)):
        if name == "device":
            continue
        if name not in a.files or name not in b.files:
            print(f"{name}: in one file only")
            same = False
            continue
        x, y = a[name], b[name]
        if name == "launches":
            eq = str(x) == str(y)
            print(f"launches equal: {eq}" + ("" if eq else
                                            f" ({x} against {y})"))
        else:
            eq = x.shape == y.shape and np.array_equal(x, y)
            diff = "" if eq or x.shape != y.shape else \
                f", max |d| {np.abs(x.astype(np.float64) - y).max():.4g}"
            print(f"{name} {x.shape}: bit-equal {eq}{diff}")
        same = same and eq
    print(f"all equal: {same}")
    return same


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    p.add_argument("--wide", action="store_true",
                   help="also vit_ln_gemm at WIDE_CASES")
    p.add_argument("--heads", action="store_true",
                   help="also the decoder kernels and keypoint head of "
                        "csrc/head_wide.cu at HEAD_CASES")
    p.add_argument("--kpts", action="store_true",
                   help="also the bias attention above 128 keypoints at "
                        "KPTS_CASES x KPTS_KEYS")
    p.add_argument("--long", action="store_true",
                   help="also the streaming attention kernels at "
                        "LONG_CASES")
    p.add_argument("--split", action="store_true",
                   help="also the model with the heads of SPLIT_CASES")
    p.add_argument("out", nargs="?")
    args = p.parse_args(argv)
    if args.compare:
        sys.exit(0 if compare(*args.compare) else 1)
    if not args.out:
        p.error("OUT.npz is needed")
    run(args.root, args.out, args.wide, args.heads, args.kpts, args.long,
        args.split)


if __name__ == "__main__":
    main()
