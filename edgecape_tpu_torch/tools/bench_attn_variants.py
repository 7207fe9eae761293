"""Micro-bench of the split ViT-block variants on the GPU; counterpart of
scripts/bench_attn_variants.py.

Times chains of 12 applications of each variant over an eval-shaped
batch (512 images, 257 tokens, C = 384, 6 heads), with seeded numpy
weights:

* `attn`:  fused_attn_block (LN -> MHA -> proj -> LayerScale residual);
* `mlp`:   fused_ln_mlp (LN -> fc1 -> GELU -> fc2 -> LayerScale residual);
* `both`:  fused_attn_block then fused_ln_mlp, the block as two halves;
* `block`: fused_vit_block, the whole block as one op.

Each chain is timed with CUDA events around the whole chain (best of
ITERS after a warm-up run) and reported as ms per layer, with the card's
name and power limit on every line.

    python -m edgecape_tpu_torch.tools.bench_attn_variants [all|attn|mlp|both|block]

Needs a CUDA device: the ops launch the hand-written kernels.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..models.dinov2 import Block, DinoV2Config
from ..ops.fused_attn_block import fused_attn_block
from ..ops.fused_mlp import fused_ln_mlp
from ..ops.fused_vit_block import fused_vit_block

B, N, C, H = 512, 257, 384, 6
LAYERS = 12
ITERS = 5
VARIANTS = ("attn", "mlp", "both", "block")


def params(rng, c: int = C, device="cuda") -> dict:
    """Seeded weights of one block, in the JAX functions' layouts
    (matrices applied as `h @ w`)."""
    def mat(i, o):
        return (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(n):
        return rng.normal(size=(n,)).astype(np.float32)

    p = {"lns": vec(c), "lnb": vec(c), "wq": mat(c, c), "bq": vec(c),
         "wk": mat(c, c), "bk": vec(c), "wv": mat(c, c), "bv": vec(c),
         "wp": mat(c, c), "bp": vec(c), "ls": np.full((c,), 0.1, np.float32),
         "n2s": vec(c), "n2b": vec(c), "w1": mat(c, 4 * c), "b1": vec(4 * c),
         "w2": mat(4 * c, c), "b2": vec(c),
         "ls2": np.full((c,), 0.1, np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in p.items()}


def as_block(p: dict):
    """A models.dinov2.Block holding the same weights (torch Linear
    layout), the module fused_vit_block reads."""
    c = p["lns"].numel()
    blk = Block(DinoV2Config(embed_dim=c)).to(p["lns"].device)
    named = {"norm1.weight": p["lns"], "norm1.bias": p["lnb"],
             "attn.qkv.weight": torch.cat([p["wq"], p["wk"], p["wv"]],
                                          dim=1).t(),
             "attn.qkv.bias": torch.cat([p["bq"], p["bk"], p["bv"]]),
             "attn.proj.weight": p["wp"].t(), "attn.proj.bias": p["bp"],
             "ls1": p["ls"], "norm2.weight": p["n2s"], "norm2.bias": p["n2b"],
             "mlp_fc1.weight": p["w1"].t(), "mlp_fc1.bias": p["b1"],
             "mlp_fc2.weight": p["w2"].t(), "mlp_fc2.bias": p["b2"],
             "ls2": p["ls2"]}
    with torch.no_grad():
        for name, t in blk.named_parameters():
            t.copy_(named[name])
    return blk.eval()


def attn_half(x, p, heads: int = H):
    return fused_attn_block(x, p["lns"], p["lnb"], p["wq"], p["bq"], p["wk"],
                            p["bk"], p["wv"], p["bv"], p["wp"], p["bp"],
                            p["ls"], num_heads=heads)


def mlp_half(x, p):
    return fused_ln_mlp(x, p["n2s"], p["n2b"], p["w1"], p["b1"], p["w2"],
                        p["b2"], p["ls2"])


def chain(which: str, x, p, layers: int = LAYERS, heads: int = H):
    """`layers` applications of one variant."""
    blk = as_block(p) if which == "block" else None
    for _ in range(layers):
        if which in ("attn", "both"):
            x = attn_half(x, p, heads)
        if which in ("mlp", "both"):
            x = mlp_half(x, p)
        if which == "block":
            x = fused_vit_block(x, blk, num_heads=heads)
    return x


def time_chain(which: str, x, p, layers: int = LAYERS, iters: int = ITERS,
               heads: int = H) -> float:
    """Best ms per layer over `iters` runs of the chain (CUDA events)."""
    chain(which, x, p, layers, heads)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        y = chain(which, x, p, layers, heads)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    if not torch.isfinite(y.float()).all():
        raise RuntimeError(f"{which}: the chain's output is not finite")
    return best / layers


def card() -> str:
    """Name and power limit of the card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else torch.cuda.get_device_name(0)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which != "all" and which not in VARIANTS:
        raise SystemExit(f"usage: bench_attn_variants [all|{'|'.join(VARIANTS)}]")
    if not torch.cuda.is_available():
        raise SystemExit("bench_attn_variants needs a CUDA device")
    rng = np.random.default_rng(0)
    p = params(rng)
    x = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).cuda()
    name = card()
    out = {}
    for v in VARIANTS:
        if which in ("all", v):
            out[v] = time_chain(v, x, p)
            print(f"{v}: {out[v]:.3f} ms/layer over {LAYERS} layers at "
                  f"[{B}, {N}, {C}], {H} heads ({name})", flush=True)
    return out


if __name__ == "__main__":
    main()
