"""The order of operations of the port's ViT attention half (csrc/kernels.cu
vit_qkv_kernel and vit_attn_kernel, ops/kernels.py vit_qkv and vit_attn),
emulated tile by tile in plain PyTorch on the CPU.

vit_qkv_kernel: x rounded to bf16, the LayerNorm prologue in the
summation order of layernorm_kernel (lane l of a warp sums the columns
64 k + 2 l + e, the partials meet in the butterfly), tiles of 128 rows
whose missing rows are zeros, 9 chunks of 128 output columns, bias on
the fp32 accumulators, q | k | v rounded to bf16.

vit_attn_kernel: items of 128 query rows of one image, 64 a warpgroup; a
warpgroup whose rows all lie past N computes nothing. Per head the
warpgroup's Q_h tile (rows past N zeros) against K_h and V_h of 272 keys
(two boxes of 136 rows: rows past N zeros, or where N <= 136 the
second box repeating the first), the keys at or beyond N masked to -inf, base-2
exponentials of the scores scaled by scale * log2(e) against the row max,
p = bf16(e * (1 / sum)), o_h = bf16(p . V_h) into slab h of the att
tile; then the projection in three chunks of 128 output columns, each
summed slab by slab (head by head) in fp32, and the epilogue fma(ls,
acc + bp, bf16(x)), stored for rows below N only.

Held against the plain versions (fused_attn_block_plain, the ops'
vit_qkv_plain and vit_attn_plain, fused_vit_block_plain with
vit_mlp_kernel's order from tests/test_torch_vit_mlp.py) and against the
JAX fused_attn_block (Pallas in interpret mode) and its reference
function. Also: the plan of vit_attn_plan, the wrappers' refusal of CPU
operands, #10's weight cache.

Tolerances. Emulation against the plain version: the same bf16 rounding
points and weights, only the fp32 sums are grouped otherwise (and the
softmax runs in base 2 with a reciprocal), so the two agree to fp32 noise
except where it flips a bf16 rounding of q, k, v, p or o (one ulp, 2^-8
relative) and carries it through the projection: max within ULP_MAX *
max(1, |plain|), mean within NOISE_MEAN. Against the JAX kernel in
interpret mode and the fp32 reference function: the bounds of
tests/test_torch_variant_ops.py for the plain version (2e-3 and 0.03 /
0.003) plus one bf16 ulp of values of order 4 (2^-5) for bf16 output."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import fused_attn_block as jattn
from edgecape_tpu_torch.models.dinov2 import Block, DinoV2Config
from edgecape_tpu_torch.ops import fused_attn_block as tattn
from edgecape_tpu_torch.ops import fused_vit_block as tvit
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain
from test_torch_vit_mlp import ln_rows, vit_mlp_tiled

ULP_MAX, NOISE_MEAN = 2.0 ** -6, 1e-4
JAX_KERN_ATOL, REF_MAX, REF_MEAN = 2e-3, 0.03, 0.003
C, H, D, KEYS, TILE = K.VIT_C, K.VIT_HEADS, K.VIT_D, K.VIT_KEYS, K.VIT_TILE
HALF = KEYS // 2            # rows of a K_h or V_h box
EPS = 1e-6
LOG2E = 1.4426950408889634


# ------------------------------------------------------------ emulations
def _fma(a, b, c):
    """fp32 fused multiply-add (one rounding), through float64."""
    return (a.double() * b.double() + c.double()).float()


def vit_qkv_tiled(x, w, *, eps=EPS):
    """vit_qkv_kernel's order on x [R, C] (fp32 or bf16): bf16 [R, 3 C]."""
    r = x.shape[0]
    h = plain.bf16(ln_rows(plain.bf16(x), w["n1w"], w["n1b"], eps))
    h = torch.cat([h, h.new_zeros((-r) % TILE, C)])
    wq = plain.bf16(w["wqkv"])
    out = []
    for h_t in h.split(TILE):
        chunks = [h_t @ wq[c:c + 128].t() + w["bqkv"][c:c + 128]
                  for c in range(0, 3 * C, 128)]
        out.append(torch.cat(chunks, dim=1))
    return torch.cat(out)[:r].to(torch.bfloat16)


def _keys(m, n, repeat=True):
    """A head's K or V buffer [KEYS, D] of the image's rows m [N, D]: two
    boxes of HALF rows, keys 0 .. 135 and 136 .. 271 or, where N <= HALF,
    keys 0 .. 135 again (repeat=False: zeros there); rows past N zeros."""
    pad = torch.cat([m, m.new_zeros(KEYS - n, D)])
    if n > HALF:
        return pad
    return torch.cat([pad[:HALF], pad[:HALF] if repeat
                      else torch.zeros_like(pad[:HALF])])


def vit_attn_tiled(qkv, x, w, *, out_dtype, probe=None, repeat=True,
                   qfill=0.0):
    """vit_attn_kernel's order on qkv bf16 [B, N, 3 C] and x [B, N, C]:
    [B, N, C] in out_dtype. probe: a dict that receives, per image, the
    number of warpgroup tiles computed; repeat: see _keys; qfill: the
    value of a query tile's rows past N (the kernel's are zeros)."""
    b, n, _ = qkv.shape
    q3 = plain.bf16(qkv)
    sl2 = torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    wp = plain.bf16(w["wp"])
    out = torch.zeros(b, n, C)
    for bi in range(b):
        kh = [_keys(q3[bi, :, C + D * h:C + D * (h + 1)], n, repeat)
              for h in range(H)]
        vh = [_keys(q3[bi, :, 2 * C + D * h:2 * C + D * (h + 1)], n, repeat)
              for h in range(H)]
        tiles = 0
        for q0 in range(0, -(-n // TILE) * TILE, 64):
            if q0 >= n:                    # a warpgroup past N
                continue
            tiles += 1
            rows = min(64, n - q0)
            slabs = []
            for h in range(H):
                q = torch.full((64, D), qfill)
                q[:rows] = q3[bi, q0:q0 + rows, D * h:D * (h + 1)]
                s = (q @ kh[h].t()) * sl2
                s[:, n:] = -math.inf
                e = torch.exp2(s - s.max(dim=1, keepdim=True).values)
                p = plain.bf16(e * (1.0 / e.sum(dim=1, keepdim=True)))
                slabs.append(plain.bf16(p @ vh[h]))
            for c in range(0, C, 128):
                acc = torch.zeros(64, 128)
                for ks in range(H):
                    acc = acc + slabs[ks] @ wp[c:c + 128,
                                               D * ks:D * (ks + 1)].t()
                y = _fma(w["ls1"][c:c + 128].float(),
                         acc + w["bp"][c:c + 128].float(),
                         torch.cat([plain.bf16(x[bi, q0:q0 + rows,
                                                 c:c + 128]),
                                    torch.zeros(64 - rows, 128)]))
                out[bi, q0:q0 + rows, c:c + 128] = y[:rows]
        if probe is not None:
            probe[bi] = tiles
    return out.to(out_dtype)


# ----------------------------------------------------------------- inputs
def _attn_args(b, n, seed=0, ls=1.0):
    """x and the weights of fused_attn_block as the JAX function takes them
    (wq, wk, wv, wproj [C, C]), numpy fp32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def mk(*sh, s=None):
        s = 1.0 / math.sqrt(sh[0]) if s is None else s
        return (rng.normal(size=sh) * s).astype(f32)

    return (rng.normal(size=(b, n, C)).astype(f32),
            (1 + 0.1 * rng.normal(size=C)).astype(f32), mk(C, s=0.1),
            mk(C, C), mk(C, s=0.1), mk(C, C), mk(C, s=0.1), mk(C, C),
            mk(C, s=0.1), mk(C, C), mk(C, s=0.1), np.full(C, ls, f32))


def _kernel_weights(args):
    return tattn._kernel_weights(*map(torch.from_numpy, args[1:]))


def _half_tiled(x, w, out_dtype):
    b, n, _ = x.shape
    qkv = vit_qkv_tiled(x.reshape(b * n, C), w).view(b, n, 3 * C)
    return vit_attn_tiled(qkv, x, w, out_dtype=out_dtype)


def _check_close(out, ref):
    d = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out.float()).all())
    bound = ULP_MAX * torch.clamp(ref.float().abs(), min=1.0)
    assert bool((d <= bound).all()), float(d.max())
    assert float(d.mean()) <= NOISE_MEAN, float(d.mean())


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("b,n", [(2, 257), (3, 37)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_half_emulation_matches_plain(b, n, dtype):
    """#10's order on the card against its plain version: 257 tokens (two
    whole items and one of a single row, whose second warpgroup computes
    nothing) and 37 tokens (one item, the key buffer's second box
    repeating the first)."""
    args = _attn_args(b, n, seed=n)
    x = torch.from_numpy(args[0]).to(dtype)
    w = _kernel_weights(args)
    probe = {}
    qkv = vit_qkv_tiled(x.reshape(b * n, C), w).view(b, n, 3 * C)
    y = vit_attn_tiled(qkv, x, w, out_dtype=dtype, probe=probe)
    assert probe == {i: -(-n // 64) for i in range(b)}
    ref = tattn.fused_attn_block_plain(x, *map(torch.from_numpy, args[1:]),
                                       num_heads=H, eps=EPS)
    assert y.dtype == dtype and y.shape == x.shape
    _check_close(y, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_kernel_emulation_matches_its_plain_version(dtype):
    """Kernel A against vit_qkv_plain, kernel B against vit_attn_plain on
    A's output, each within the ulp bound."""
    args = _attn_args(2, 140, seed=11)
    x = torch.from_numpy(args[0]).to(dtype)
    w = _kernel_weights(args)
    qkv = vit_qkv_tiled(x.reshape(-1, C), w)
    _check_close(qkv, tattn.vit_qkv_plain(x.reshape(-1, C), w, eps=EPS))
    y = vit_attn_tiled(qkv.view(2, 140, 3 * C), x, w,
                       out_dtype=torch.float32)
    _check_close(y, tattn.vit_attn_plain(qkv.view(2, 140, 3 * C), x, w,
                                         num_heads=H,
                                         out_dtype=torch.float32))


def test_key_buffer_padding_and_query_padding_change_nothing():
    """The keys past N (the second box repeating the first where N <= 136)
    meet masked scores and zero probabilities, and the rows of a query
    tile past N never reach a real row: the outputs are those with a zero
    second box and with other values in the padded query rows."""
    args = _attn_args(1, 100, seed=5)
    w = _kernel_weights(args)
    x = torch.from_numpy(args[0])
    qkv = vit_qkv_tiled(x.reshape(-1, C), w).view(1, 100, 3 * C)
    ref = vit_attn_tiled(qkv, x, w, out_dtype=torch.float32)
    assert torch.equal(ref, vit_attn_tiled(qkv, x, w, out_dtype=torch.float32,
                                           repeat=False))
    assert torch.equal(ref, vit_attn_tiled(qkv, x, w, out_dtype=torch.float32,
                                           qfill=3.0))


@pytest.mark.parametrize("b,n", [(2, 37), (1, 257)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_half_emulation_matches_jax(b, n, dtype):
    """Against the Pallas kernel in interpret mode (the same rounding
    points) and the fp32 reference function, LayerScale 0.1 as in the
    variant tests."""
    args = _attn_args(b, n, seed=3, ls=0.1)
    jx = jnp.asarray(args[0]).astype(dtype)
    kern = jattn.fused_attn_block(jx, *map(jnp.asarray, args[1:]),
                                  num_heads=H, interpret=True)
    ref = jattn.reference_attn_block(jx, *map(jnp.asarray, args[1:]),
                                     num_heads=H)
    tx = torch.from_numpy(args[0]).to(getattr(torch, dtype))
    out = _half_tiled(tx, _kernel_weights(args), tx.dtype).float().numpy()
    ulp = 2.0 ** -5 if dtype == "bfloat16" else 0.0
    d_kern = np.abs(out - np.asarray(kern.astype(jnp.float32)))
    assert d_kern.max() <= JAX_KERN_ATOL + ulp, d_kern.max()
    d = np.abs(out - np.asarray(ref.astype(jnp.float32)))
    assert d.max() <= REF_MAX + ulp and d.mean() <= REF_MEAN + ulp / 8


def _blocks(seed):
    cfg = DinoV2Config()
    g = torch.Generator().manual_seed(seed)
    blks = []
    for _ in range(2):
        blk = Block(cfg)
        with torch.no_grad():
            for name, p in blk.named_parameters():
                if p.dim() == 2:
                    p.copy_(torch.randn(p.shape, generator=g)
                            / math.sqrt(p.shape[1]))
                elif name.endswith(("ls1", "ls2")):
                    p.fill_(1.0)
                else:
                    p.copy_(torch.randn(p.shape, generator=g) * 0.1
                            + (1.0 if name.endswith("weight") else 0.0))
        blks.append(blk.eval())
    return blks


def block_tiled(x, blk, *, out_dtype=None):
    """A ViT block as the card runs it: vit_qkv_kernel's and
    vit_attn_kernel's order (the fp32 x1), then vit_mlp_kernel's."""
    w = tvit._prepare(blk)
    b, n, c = x.shape
    x1 = _half_tiled(x, w, torch.float32)
    y, _ = vit_mlp_tiled(x1.reshape(b * n, c), w,
                         out_dtype=out_dtype or x.dtype)
    return y.view(b, n, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_and_pair_in_the_cards_order(dtype):
    """#1 in the card's order (three kernels) against the plain block at
    the model's width; #2's pair, the first block's result stored as
    bf16, bit-equal to two blocks in that order."""
    blk_a, blk_b = _blocks(5)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 37, C, generator=g).to(dtype)
    with torch.no_grad():
        one = block_tiled(x, blk_a)
        _check_close(one, tvit.fused_vit_block_plain(x, blk_a, num_heads=H))
        two = block_tiled(one, blk_b)
        mid = block_tiled(x, blk_a, out_dtype=torch.bfloat16)
        pair = block_tiled(mid, blk_b, out_dtype=dtype)
    assert pair.dtype == dtype and torch.equal(pair, two)


def test_vit_attn_plan():
    assert K.vit_attn_plan(510, 257, C, H) == {
        "qkv_tiles": 1024, "items": 1530, "items_per_image": 3,
        "query_tiles": 5, "pad_rows": 127, "key_pad": 272,
        "smem_bytes": K.VIT_ATTN_SMEM}
    # the support pass: 102 items for the card's 132 SMs, one round
    assert K.vit_attn_plan(34, 257, C, H)["items"] == 102
    assert K.vit_attn_plan(32, 257, C, H)["qkv_tiles"] == 65
    assert K.vit_attn_plan(3, 37, C, H) == {
        "qkv_tiles": 1, "items": 3, "items_per_image": 1, "query_tiles": 1,
        "pad_rows": 91, "key_pad": 272, "smem_bytes": K.VIT_ATTN_SMEM}
    assert K.vit_attn_plan(1, KEYS, C, H)["items_per_image"] == 3
    assert K.VIT_ATTN_SMEM <= 232448
    # past the score row's 272 keys the attention streams its keys
    assert K.vit_attn_plan(1, 273, C, H)["long"]
    # other widths take the wide route (tests/test_torch_vit_widths.py);
    # what it does not take stays refused
    assert K.vit_attn_plan(2, 37, 128, 2)["wide"]
    assert K.vit_attn_plan(2, 37, C, 8)["wide"]
    for b, n, c, h in ((1, 0, C, H), (0, 10, C, H),
                       (2, 37, 256, H), (2, 37, 1088, 17), (2, 37, 1024, 4)):
        with pytest.raises(ValueError):
            K.vit_attn_plan(b, n, c, h)


def test_wrappers_refuse_cpu_operands_and_count_nothing():
    args = _attn_args(1, 20)
    w = _kernel_weights(args)
    x = torch.from_numpy(args[0])
    before = dict(K.launches)
    with pytest.raises(ValueError):
        K.vit_qkv(x.reshape(-1, C), w, eps=EPS)
    with pytest.raises(ValueError):
        K.vit_attn(torch.zeros(1, 20, 3 * C, dtype=torch.bfloat16), x, w,
                   out_dtype=torch.float32)
    assert K.launches == before
    n0 = tattn.launches
    out = tattn.fused_attn_block(x, *map(torch.from_numpy, args[1:]),
                                 num_heads=H)
    assert out.shape == x.shape and tattn.launches == n0
    assert K.launches == before


def test_fused_attn_block_weights_are_kept_until_written():
    """#10's JAX-layout weights are laid out and cast once (so a call on
    the card is two launches) and again after a source is written in
    place."""
    args = [torch.from_numpy(a) for a in _attn_args(1, 5)[1:]]
    first = tattn._kernel_weights(*args)
    assert tattn._kernel_weights(*args) is first
    assert first["wqkv"].shape == (3 * C, C)
    assert first["wqkv"].dtype == torch.bfloat16
    assert torch.equal(first["wqkv"][C:2 * C],
                       args[4].t().to(torch.bfloat16))
    assert torch.equal(first["wp"], args[8].t().to(torch.bfloat16))
    with torch.no_grad():
        args[4].mul_(2.0)
    second = tattn._kernel_weights(*args)
    assert second is not first
    assert torch.equal(second["wqkv"][C:2 * C],
                       args[4].t().to(torch.bfloat16))
