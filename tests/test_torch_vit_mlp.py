"""The order of operations of the port's ViT MLP kernel (csrc/kernels.cu
vit_mlp_kernel, ops/kernels.py vit_mlp), emulated tile by tile in plain
PyTorch on the CPU: the LayerNorm prologue with the summation order it
shares with layernorm_kernel (lane l of a warp sums the columns 64 k + 2 l
+ e in that order, the 32 partials meet in the butterfly 16, 8, 4, 2, 1
lanes apart), tiles of 128 rows whose missing rows are zeros, the hidden
in chunks of 64 columns through the Abramowitz & Stegun erf of the kernel
(gelu_as) and rounded to bf16, fc2 accumulated chunk by chunk from chunk 0
in every tile of every block (so a row's bits do not depend on the tile
or the call it lands in), the LayerScale residual from x unrounded, and the next block's LayerNorm of
bf16(y) in the epilogue, summed by a quad of threads a row. Held against
the plain versions of fused_ln_mlp and fused_vit_block and against the
JAX fused_ln_mlp (Pallas in interpret mode) and its reference function.
Also: the epilogue's quad order gives layernorm_kernel's bits, the tile
plan of vit_mlp_plan, and the wrapper's refusal of CPU operands.

Tolerances. Emulation against the plain version: the same bf16 rounding
points and weights, only the fp32 sums are grouped otherwise (and the
erf is A&S 7.1.26, within 1.5e-7 of erf), so the two agree to fp32 noise
except where it flips a bf16 rounding of a hidden value or of a bf16
output (one ulp, 2^-8 relative): max within ULP_MAX * max(1, |plain|),
mean within NOISE_MEAN. Against the JAX kernel in interpret mode: the
tanh / erf GELU gap pushed through fc2 and LayerScale plus 2e-3
(JAX_KERN_ATOL), and one bf16 ulp of values of order 4 (2^-5) for bf16
output; against the fp32 reference function: 0.02 max and 0.002 mean
(REF_MAX, REF_MEAN, the JAX package's own kernel-test bounds) plus that
ulp, as tests/test_torch_variant_ops.py holds the plain version."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import fused_mlp as jmlp
from edgecape_tpu_torch.models.dinov2 import Block, DinoV2Config
from edgecape_tpu_torch.ops import fused_mlp as tmlp
from edgecape_tpu_torch.ops import fused_vit_block as tvit
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain

ULP_MAX, NOISE_MEAN = 2.0 ** -6, 1e-4
JAX_KERN_ATOL, REF_MAX, REF_MEAN = 2e-3, 0.02, 0.002
C, F, TILE, CHUNK = K.VIT_C, 4 * K.VIT_C, K.VIT_TILE, K.VIT_CHUNK
EPS = 1e-6


# ------------------------------------------------------------ emulations
def _fma(a, b, c):
    """fp32 fused multiply-add (one rounding), through float64."""
    return (a.double() * b.double() + c.double()).float()


def _lane_partials(v, mean=None):
    """Per lane l of a warp, the sum of v[:, 64 k + 2 l + e] (or of the
    squared deviations from `mean`) in the order k, e: [R, 32] fp32."""
    cols = v.reshape(v.shape[0], -1, 32, 2)            # [R, k, lane, e]
    s = torch.zeros(v.shape[0], 32)
    for k in range(cols.shape[1]):
        for e in range(2):
            x = cols[:, k, :, e]
            s = s + x if mean is None else _fma(x - mean, x - mean, s)
    return s


def _butterfly(p):
    """warp_sum: lanes 16, 8, 4, 2, 1 apart; every lane ends equal."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        p = p + p[:, idx ^ o]
    return p[:, 0]


def _quad_sum(v, mean=None):
    """vm_row_sum: thread t of a quad holds the lanes 4 v + t, forms the
    butterfly's steps 16, 8, 4 in registers, then 2 and 1 by shuffles."""
    p = _lane_partials(v, mean).reshape(-1, 8, 4)      # [R, v, t]
    q = [p[:, i] + p[:, i + 4] for i in range(4)]
    s = (q[0] + q[2]) + (q[1] + q[3])                  # [R, t]
    s = s + s[:, [2, 3, 0, 1]]
    return (s + s[:, [1, 0, 3, 2]])[:, 0]


def ln_rows(v, g, b, eps=EPS, quad=False):
    """LayerNorm in the kernels' order: fp32 [R, C]."""
    total = _quad_sum if quad else (lambda x, m=None: _butterfly(
        _lane_partials(x, m)))
    mean = (total(v) / v.shape[1])[:, None]
    inv = torch.rsqrt(total(v, mean) / v.shape[1] + eps)[:, None]
    return _fma((v - mean) * inv, g.float(), b.float())


def gelu_as(x):
    """gelu_as of csrc/kernels.cu: exact-erf GELU with the A&S 7.1.26
    erf."""
    z = x * 0.70710678118654752
    az = z.abs()
    t = 1.0 / (0.3275911 * az + 1.0)
    poly = t * (t * (t * (t * (t * 1.061405429 - 1.453152027)
                          + 1.421413741) - 0.284496736) + 0.254829592)
    return 0.5 * x * (1.0 + torch.copysign(1.0 - poly * torch.exp(-az * az),
                                           z))


def vit_mlp_tiled(x, w, *, eps=EPS, out_dtype=None, next_ln=None):
    """vit_mlp_kernel's order on x [R, C] (fp32 or bf16): (y [R, C] in
    out_dtype, h_next fp32 holding bf16 values or None). w: torch Linear
    layout (w1 [F, C], w2 [C, F]) and fp32 vectors."""
    r = x.shape[0]
    xf = x.float()
    h = plain.bf16(ln_rows(xf, w["g"], w["be"], eps))
    pad = (-r) % TILE
    h = torch.cat([h, h.new_zeros(pad, C)])
    w1, w2 = plain.bf16(w["w1"]), plain.bf16(w["w2"])
    chunks = w1.shape[0] // CHUNK
    out = []
    for h_t in h.split(TILE):
        acc = torch.zeros(TILE, C)
        for k in range(chunks):
            j = CHUNK * k
            f = plain.bf16(gelu_as(h_t @ w1[j:j + CHUNK].t()
                                   + w["b1"][j:j + CHUNK]))
            acc = acc + f @ w2[:, j:j + CHUNK].t()
        out.append(acc)
    acc = torch.cat(out)[:r]
    y = _fma(w["ls"].float(), acc + w["b2"].float(), xf)
    hn = None
    if next_ln is not None:
        hn = plain.bf16(ln_rows(plain.bf16(y), *next_ln, eps, quad=True))
    return y.to(out_dtype or x.dtype), hn


# ----------------------------------------------------------------- inputs
def _mlp_args(rows, seed=0, ls=1.0):
    """x and the weights of fused_ln_mlp as the JAX function takes them
    (w1 [C, F], w2 [F, C]), numpy fp32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(rows, C)).astype(f32),
            (1 + 0.1 * rng.normal(size=C)).astype(f32),
            (0.1 * rng.normal(size=C)).astype(f32),
            (rng.normal(size=(C, F)) / math.sqrt(C)).astype(f32),
            (0.1 * rng.normal(size=F)).astype(f32),
            (rng.normal(size=(F, C)) / math.sqrt(F)).astype(f32),
            (0.1 * rng.normal(size=C)).astype(f32),
            np.full(C, ls, f32))


def _kernel_weights(args):
    """The kernel's weight dict (torch Linear layout) of _mlp_args."""
    _, g, be, w1, b1, w2, b2, ls = map(torch.from_numpy, args)
    return {"g": g, "be": be, "w1": w1.t().contiguous(), "b1": b1,
            "w2": w2.t().contiguous(), "b2": b2, "ls": ls}


def _check_close(out, ref):
    d = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out.float()).all())
    bound = ULP_MAX * torch.clamp(ref.float().abs(), min=1.0)
    assert bool((d <= bound).all()), float(d.max())
    assert float(d.mean()) <= NOISE_MEAN, float(d.mean())


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epilogue_quad_order_gives_layernorm_kernel_bits(seed):
    """The next block's LayerNorm, summed over a quad in the epilogue,
    equals layernorm_kernel's warp order bit for bit (the pair's claim to
    be bit-equal to two blocks rests on it)."""
    rng = np.random.default_rng(seed)
    v = plain.bf16(torch.from_numpy(
        (rng.normal(size=(64, C)) * rng.uniform(0.1, 20, size=(64, 1)) +
         rng.normal(size=(64, 1))).astype(np.float32)))
    assert torch.equal(_quad_sum(v), _butterfly(_lane_partials(v)))
    mean = (_quad_sum(v) / C)[:, None]
    assert torch.equal(_quad_sum(v, mean),
                       _butterfly(_lane_partials(v, mean)))
    g, b = (torch.from_numpy(rng.normal(size=C).astype(np.float32))
            for _ in range(2))
    assert torch.equal(ln_rows(v, g, b, quad=True), ln_rows(v, g, b))
    np.testing.assert_allclose(ln_rows(v, g, b).numpy(),
                               plain.layer_norm(v, g, b, EPS).numpy(),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("rows", [300, 128, 44])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_mlp_emulation_matches_fused_ln_mlp_plain(rows, dtype):
    """#9's order on the card against its plain version: a ragged last
    tile (300 rows: 2 tiles + 44), one whole tile, and one ragged tile."""
    args = _mlp_args(rows, seed=rows)
    x = torch.from_numpy(args[0]).to(dtype)
    y, hn = vit_mlp_tiled(x, _kernel_weights(args))
    ref = tmlp.fused_ln_mlp_plain(x, *map(torch.from_numpy, args[1:]),
                                  eps=EPS)
    assert y.dtype == dtype and hn is None
    _check_close(y, ref)


def test_vit_mlp_padding_rows_contribute_nothing():
    """Rows of a tile are independent: the first rows of a ragged call
    are those of a longer call bit for bit."""
    args = _mlp_args(300, seed=7)
    x = torch.from_numpy(args[0])
    w = _kernel_weights(args)
    short, _ = vit_mlp_tiled(x[:131], w)
    full, _ = vit_mlp_tiled(x, w)
    assert torch.equal(short, full[:131])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_mlp_emulation_matches_jax(dtype):
    """Against the Pallas kernel in interpret mode (tanh GELU there) and
    the fp32 reference function, LayerScale 0.1 as in the variant tests."""
    args = _mlp_args(2 * 97, seed=3, ls=0.1)
    x3 = args[0].reshape(2, 97, C)
    jx = jnp.asarray(x3).astype(dtype)
    kern = jmlp.fused_ln_mlp(jx, *map(jnp.asarray, args[1:]), interpret=True)
    ref = jmlp.reference_ln_mlp(jx, *map(jnp.asarray, args[1:]))
    tx = torch.from_numpy(args[0]).to(getattr(torch, dtype))
    y, _ = vit_mlp_tiled(tx, _kernel_weights(args))
    out = y.float().numpy().reshape(2, 97, C)
    h = torch.from_numpy(np.linspace(-6, 6, 4001).astype(np.float32))
    gap = float((torch.nn.functional.gelu(h, approximate="tanh")
                 - torch.nn.functional.gelu(h)).abs().max())
    w2_l1 = float(np.abs(args[5]).sum(axis=0).max())
    ulp = 2.0 ** -5 if dtype == "bfloat16" else 0.0
    d_kern = np.abs(out - np.asarray(kern.astype(jnp.float32)))
    assert d_kern.max() <= gap * w2_l1 * 0.1 + JAX_KERN_ATOL + ulp
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


def block_tiled(x, blk, *, h=None, next_blk=None, out_dtype=None):
    """A ViT block as the card runs it: LN1 in layernorm_kernel's order
    (or h from the previous block's kernel), q, k, v and attention as the
    plain version forms them, the fp32 x1, then vit_mlp_kernel's order.
    Returns (y, the next block's h or None)."""
    w = tvit._prepare(blk)
    b, n, c = x.shape
    xb = plain.bf16(x).reshape(b * n, c)
    if h is None:
        h = plain.bf16(ln_rows(xb, w["n1w"], w["n1b"]))
    qkv = plain.bf16(plain.linear(h, w["wqkv"], w["bqkv"])).view(b, n, 3 * c)
    att = plain.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                          num_heads=6, scale=1.0 / math.sqrt(c // 6))
    x1 = xb + w["ls1"] * plain.linear(att.reshape(b * n, c), w["wp"],
                                      w["bp"])
    nxt = None
    if next_blk is not None:
        wn = tvit._prepare(next_blk)
        nxt = (wn["n1w"], wn["n1b"])
    y, hn = vit_mlp_tiled(x1, w, out_dtype=out_dtype or x.dtype,
                          next_ln=nxt)
    return y.view(b, n, c), hn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_and_pair_in_the_cards_order(dtype):
    """#1 in the card's order against the plain block at the model's
    width; #2's pair, whose first block writes the second's LN1 in its
    epilogue, bit-equal to two blocks in that order."""
    blk_a, blk_b = _blocks(5)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 37, C, generator=g).to(dtype)
    with torch.no_grad():
        one, _ = block_tiled(x, blk_a)
        _check_close(one, tvit.fused_vit_block_plain(x, blk_a, num_heads=6))
        two, _ = block_tiled(one, blk_b)
        mid, h = block_tiled(x, blk_a, next_blk=blk_b,
                             out_dtype=torch.bfloat16)
        pair, _ = block_tiled(mid, blk_b, h=h, out_dtype=dtype)
    assert pair.dtype == dtype and torch.equal(pair, two)


def test_vit_mlp_plan():
    assert K.vit_mlp_plan(510 * 257, C, F) == {"tiles": 1024, "pad_rows": 2,
                                               "chunks": 24}
    # the support pass: 69 tiles for the card's 132 SMs, one round
    assert K.vit_mlp_plan(34 * 257, C, F) == {"tiles": 69, "pad_rows": 94,
                                              "chunks": 24}
    assert K.vit_mlp_plan(2 * 16 * 257, C, F)["tiles"] == 65
    assert K.vit_mlp_plan(1, C, 64) == {"tiles": 1, "pad_rows": 127,
                                        "chunks": 1}
    # another width takes the wide route (tests/test_torch_vit_widths.py)
    assert K.vit_mlp_plan(300, 256, F)["wide"]
    for rows, c, f in ((300, 1088, F), (300, 128, 200), (300, C, 1000),
                       (300, C, 0), (0, C, F)):
        with pytest.raises(ValueError):
            K.vit_mlp_plan(rows, c, f)


def test_vit_mlp_refuses_cpu_operands_and_counts_nothing():
    args = _mlp_args(10)
    w = _kernel_weights(args)
    w = {k: v.to(torch.bfloat16) if v.dim() == 2 else v for k, v in
         w.items()}
    w["kmajor"] = True
    before = dict(K.launches)
    with pytest.raises(ValueError):
        K.vit_mlp(torch.from_numpy(args[0]), w, eps=EPS,
                  out_dtype=torch.float32)
    with pytest.raises(ValueError):
        K.vit_mlp(torch.from_numpy(args[0]).to(torch.bfloat16), w, eps=EPS,
                  out_dtype=torch.bfloat16, next_ln=(w["g"], w["be"]))
    assert K.launches == before
    n0 = tmlp.launches
    tmlp.fused_ln_mlp(torch.from_numpy(args[0]),
                      *map(torch.from_numpy, args[1:]))
    assert tmlp.launches == n0 and K.launches == before


def test_fused_ln_mlp_weight_cast_is_kept_until_written():
    """#9's fp32 weights are cast to bf16 once (so a call on the card is one
    launch) and cast again after the source is written in place; bf16
    contiguous weights are taken as they are."""
    w = torch.randn(C, F)
    first = tmlp._bf16(w)
    assert first.dtype == torch.bfloat16 and tmlp._bf16(w) is first
    with torch.no_grad():
        w.mul_(2.0)
    second = tmlp._bf16(w)
    assert second is not first and torch.equal(second, w.to(torch.bfloat16))
    wb = torch.randn(C, F).to(torch.bfloat16)
    assert tmlp._bf16(wb).data_ptr() == wb.data_ptr()
