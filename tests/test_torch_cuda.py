"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, at small shapes with ragged edges. Marked `cuda`: they skip
without a CUDA device (the decision is made inside the fixture). On the
machine with the card:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: tests/conftest.py configures jax, which that machine does
not have.)

Tolerance: |kernel - plain| <= 1e-2 + 2^-6 |plain| (both sides follow the
same bf16 rounding points; summation order can move a bf16 value by an
ulp and carry it through the op); fp32 GEMM results 1e-4 relative."""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    return torch.device("cuda", 0)


def _rn(dev, *shape, s=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * s).to(dev)


def _close(out, ref):
    d = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((d <= 1e-2 + 2 ** -6 * ref.float().abs()).all()), \
        d.max().item()


def _randomize(module, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=g)
                        / math.sqrt(p.shape[1]))
            elif name.endswith(("ls1", "ls2")):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1
                        + (1.0 if name.endswith("weight") else 0.0))
    return module.to(dev).eval()


@pytest.mark.parametrize("b_nk", [True, False])
def test_gemm_epilogues(dev, b_nk):
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops import plain
    a = _rn(dev, 67, 40).to(torch.bfloat16)
    w = _rn(dev, 33, 40, seed=1).to(torch.bfloat16)
    bias, res, ls = _rn(dev, 33, seed=2), _rn(dev, 67, 33, seed=3), \
        _rn(dev, 33, seed=4)
    b = w if b_nk else w.t().contiguous()
    ref = a.float() @ w.float().t() + bias
    out = K.gemm(a, b, b_nk=b_nk, bias=bias, act=K.ACT_GELU, res=res, ls=ls,
                 out_dtype=torch.float32)
    torch.testing.assert_close(out, res + ls * plain.gelu(ref), rtol=1e-4,
                               atol=1e-4)


def _modules():
    from edgecape_tpu_torch.models.dinov2 import Block, DinoV2Config
    from edgecape_tpu_torch.models.transformer import (DecoderLayer,
                                                       EncoderLayer)
    return Block, DinoV2Config, DecoderLayer, EncoderLayer


def test_fused_vit_block_matches_plain(dev):
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    Block, DinoV2Config, _, _ = _modules()
    with torch.no_grad():
        blk = _randomize(Block(DinoV2Config(embed_dim=128, num_heads=2)),
                         dev)
        x = _rn(dev, 3, 37, 128).to(torch.bfloat16)
        _close(FV.fused_vit_block(x, blk, num_heads=2),
               FV.fused_vit_block_plain(x, blk, num_heads=2))


def test_fused_encoder_layers_and_stack_match_plain(dev):
    """Each layer of the stack against the plain layer on the kernel's own
    input (a near-tie in one layer's softmax would otherwise be amplified
    by the next), then the stack against the chain of layer launches."""
    from edgecape_tpu_torch.ops import fused_encoder as FE
    _, _, _, EncoderLayer = _modules()
    with torch.no_grad():
        enc = [_randomize(EncoderLayer(64, 2, 96), dev, seed=s)
               for s in (1, 2)]
        tok = _rn(dev, 3, 41, 64).to(torch.bfloat16)
        pos = _rn(dev, 41, 64, seed=5)
        valid = _rn(dev, 3, 41, seed=6) > -0.5
        valid[:, 0] = True
        x = tok
        for layer in enc:
            y = FE.fused_encoder_layer(x, pos, valid, layer, num_heads=2)
            _close(y, FE.fused_encoder_layer_plain(x, pos, valid, layer,
                                                   num_heads=2))
            x = y
        assert torch.equal(FE.fused_encoder_stack(tok, pos, valid, enc,
                                                  num_heads=2), x)


def test_fused_decoder_layer_matches_plain(dev):
    from edgecape_tpu_torch.ops import fused_decoder as FD
    _, _, DecoderLayer, _ = _modules()
    with torch.no_grad():
        dec = _randomize(DecoderLayer(64, 2, 96), dev)
        kx = _rn(dev, 3, 13, 64).to(torch.bfloat16)
        qpos, img = _rn(dev, 3, 13, 64, seed=7), _rn(dev, 3, 20, 64, seed=8)
        ipos = _rn(dev, 20, 64, seed=9)
        kvalid = _rn(dev, 3, 13, seed=10) > -0.5
        kvalid[:, 0] = True
        bias = _rn(dev, 3, 2, 13, 13, seed=11)
        adj = _rn(dev, 3, 2, 13, 13, seed=12).abs() / 13
        args = (kx, qpos, img, ipos, kvalid, bias, adj, dec)
        _close(FD.fused_decoder_layer(*args, num_heads=2),
               FD.fused_decoder_layer_plain(*args, num_heads=2))


def test_flash_mha_matches_plain(dev):
    from edgecape_tpu_torch.ops import flash_attention as FA
    with torch.no_grad():
        q, k, v = (_rn(dev, 2, 19, 4, 32, seed=s) for s in (13, 14, 15))
        fvalid = _rn(dev, 2, 19, seed=16) > 0
        fvalid[:, 0] = True
        _close(FA.flash_mha(q, k, v, fvalid),
               FA.flash_mha_plain(q, k, v, fvalid))


def _train_case(dev, b, n, h, d, masked, with_bias, seed=20):
    q, k, v, g = (_rn(dev, b, n, h, d, seed=seed + i) for i in range(4))
    valid = None
    if masked:
        valid = _rn(dev, b, n, seed=seed + 4) > -0.3
        valid[:, 0] = True
    bias = _rn(dev, b, h, n, n, seed=seed + 5) if with_bias else None
    return q, k, v, g, valid, bias


def _grads(fn, q, k, v, g, valid, bias, **kw):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    bl = None if bias is None else bias.clone().requires_grad_(True)
    out = fn(*leaves, valid, bl, **kw)
    grads = torch.autograd.grad(out, leaves + ([bl] if bl is not None
                                               else []), g)
    return out.detach(), grads


# odd N, N < D, D = 64, N past one 16-warp round of query tiles
TRAIN_SHAPES = [(2, 19, 4, 32), (1, 7, 2, 32), (2, 45, 2, 64),
                (1, 300, 2, 32)]


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_mha_train_matches_plain(dev, shape, masked, with_bias):
    """Forward and dq, dk, dv, dbias at rate 0 against autograd through
    the plain version (same rounding points)."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    case = _train_case(dev, *shape, masked, with_bias)
    out, grads = _grads(FA.flash_mha_train, *case)
    ref, rgrads = _grads(FA.flash_mha_train_plain, *case)
    assert out.dtype == torch.float32
    _close(out, ref)
    for a, r in zip(grads, rgrads):
        _close(a, r)


@pytest.mark.parametrize("shape", TRAIN_SHAPES[:3])
def test_flash_mha_train_dropout_uses_one_mask(dev, shape):
    """At rate 0.25 the kernels agree, forward and backward, with the
    plain version fed the kernels' own keep mask; the mask keeps about
    3/4; the same seed repeats the output and another seed does not."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, n, h, d = shape
    case = _train_case(dev, *shape, True, True)
    rate = 0.25

    def gen(s):
        return torch.Generator().manual_seed(s)

    seed = FA.dropout_seed(gen(3), dev)
    keep = K.dropout_mask(seed, rate, b * h, n, n).reshape(b, h, n, n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.05
    out, grads = _grads(FA.flash_mha_train, *case, dropout_rate=rate,
                        generator=gen(3))
    ref, rgrads = _grads(FA.flash_mha_train_plain, *case, dropout_rate=rate,
                         keep=keep)
    _close(out, ref)
    for a, r in zip(grads, rgrads):
        _close(a, r)
    again, _ = _grads(FA.flash_mha_train, *case, dropout_rate=rate,
                      generator=gen(3))
    other, _ = _grads(FA.flash_mha_train, *case, dropout_rate=rate,
                      generator=gen(4))
    assert torch.equal(out, again) and not torch.equal(out, other)


def test_flash_mha_train_fully_masked_row_is_zero(dev):
    """A batch row with every key masked gives 0 and zero gradients (the
    model's ensure_some_valid keeps this off the path)."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    q, k, v, g, valid, _ = _train_case(dev, 2, 19, 2, 32, True, False)
    valid[1] = False
    for fn in (FA.flash_mha_train, FA.flash_mha_train_plain):
        out, grads = _grads(fn, q, k, v, g, valid, None)
        assert bool((out[1] == 0).all())
        assert all(bool(torch.isfinite(t).all()) and
                   bool((t[1] == 0).all()) for t in grads)


def test_flash_mha_train_refuses_unsupported_shapes(dev):
    from edgecape_tpu_torch.ops import flash_attention as FA
    with pytest.raises(ValueError):
        FA.flash_mha_train(*(_rn(dev, 1, 8, 2, 16) for _ in range(3)))
    with pytest.raises(ValueError):
        FA.flash_mha_train(*(_rn(dev, 1, 513, 1, 32) for _ in range(3)))


# ------------------------------------------------- kernel-variant ops
def _half_args(dev, c, f, seed=3):
    g = torch.Generator().manual_seed(seed)

    def mat(i, o):
        return (torch.randn(i, o, generator=g) / math.sqrt(i)).to(dev)

    def vec(n, s=0.1, shift=0.0):
        return (torch.randn(n, generator=g) * s + shift).to(dev)

    attn = (vec(c, shift=1.0), vec(c), mat(c, c), vec(c), mat(c, c), vec(c),
            mat(c, c), vec(c), mat(c, c), vec(c), torch.ones(c, device=dev))
    mlp = (vec(c, shift=1.0), vec(c), mat(c, f), vec(f), mat(f, c), vec(c),
           torch.ones(c, device=dev))
    return attn, mlp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ln_mlp_matches_plain(dev, dtype):
    from edgecape_tpu_torch.ops import fused_mlp as FM
    _, mlp = _half_args(dev, 128, 200)
    x = _rn(dev, 3, 37, 128).to(dtype)
    n0 = FM.launches
    out = FM.fused_ln_mlp(x, *mlp)
    assert out.dtype == dtype and FM.launches == n0 + 1
    _close(out, FM.fused_ln_mlp_plain(x, *mlp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attn_block_matches_plain(dev, dtype):
    from edgecape_tpu_torch.ops import fused_attn_block as FB
    attn, _ = _half_args(dev, 128, 200)
    x = _rn(dev, 3, 37, 128).to(dtype)
    n0 = FB.launches
    out = FB.fused_attn_block(x, *attn, num_heads=2)
    assert out.dtype == dtype and FB.launches == n0 + 1
    _close(out, FB.fused_attn_block_plain(x, *attn, num_heads=2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_vit_block2_bit_equal_to_two_blocks(dev, dtype):
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    Block, DinoV2Config, _, _ = _modules()
    cfg = DinoV2Config(embed_dim=128, num_heads=2)
    with torch.no_grad():
        a, b = _randomize(Block(cfg), dev, 1), _randomize(Block(cfg), dev, 2)
        x = _rn(dev, 3, 37, 128).to(dtype)
        n1, n2 = FV.launches, FV.launches2
        pair = FV.fused_vit_block2(x, a, b, num_heads=2)
        assert (FV.launches, FV.launches2) == (n1, n2 + 1)
        two = FV.fused_vit_block(FV.fused_vit_block(x, a, num_heads=2), b,
                                 num_heads=2)
        assert pair.dtype == dtype and torch.equal(pair, two)


def test_gemm_two_output_columns(dev):
    """kpt_branch's last layer: N = 2, a sliver of one 128-wide tile."""
    from edgecape_tpu_torch.ops import kernels as K
    a = _rn(dev, 300, 64).to(torch.bfloat16)
    w = _rn(dev, 2, 64, seed=1).to(torch.bfloat16)
    bias = _rn(dev, 2, seed=2)
    out = K.gemm(a, w, b_nk=True, bias=bias, out_dtype=torch.float32)
    assert out.shape == (300, 2)
    torch.testing.assert_close(out, a.float() @ w.float().t() + bias,
                               rtol=1e-4, atol=1e-4)


def test_attention_forms_the_markov_bias_from_the_hop_stack(dev):
    """The bias formed in the kernel from the bf16 hop stack against the
    same bias computed by PyTorch and handed in as a tensor."""
    from edgecape_tpu_torch.ops import kernels as K
    b, n, h, d, nhop, hid = 3, 37, 4, 32, 5, 9
    q, k, v = (_rn(dev, b, n, h * d, seed=s).to(torch.bfloat16)
               for s in (1, 2, 3))
    hops = torch.rand(b, nhop, n, n, generator=torch.Generator()
                      .manual_seed(4)).to(dev).to(torch.bfloat16)
    w1, b1 = _rn(dev, nhop, hid, seed=5), _rn(dev, hid, seed=6)
    w2, b2 = _rn(dev, hid, h, seed=7), _rn(dev, h, seed=8)
    kb = torch.zeros(b, n, device=dev)
    kb[:, -5:] = -math.inf
    hf = hops.float().permute(0, 2, 3, 1)                  # [B, N, N, hop]
    bias = (torch.relu(hf @ w1 + b1) @ w2 + b2).permute(0, 3, 1, 2)
    ref = K.attention(q, k, v, num_heads=h, scale=d ** -0.5, key_bias=kb,
                      bias=bias.contiguous())
    out = K.attention(q, k, v, num_heads=h, scale=d ** -0.5, key_bias=kb,
                      hops=hops, hop_mlp=(w1, b1, w2, b2))
    d_ = (out.float() - ref.float()).abs()
    # the two sum the MLP in another order: at most a bf16 ulp of an output
    assert d_.max().item() <= 2 ** -7 and d_.mean().item() <= 1e-4


def test_sine_feats_and_coord_update_match_pytorch(dev):
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops.fused_decoder import _rdt
    from edgecape_tpu_torch.ops.pos_enc import inverse_sigmoid
    g = torch.Generator().manual_seed(9)
    ct = torch.rand(77, 2, generator=g).to(dev)
    ct[0] = torch.tensor([0.0, 1.0])          # the clipped ends
    rdt = _rdt(16, dev)
    feats = K.sine_feats(ct, rdt)
    ax = (ct[:, 0:1] * 6.283185307179586) * rdt
    ay = (ct[:, 1:2] * 6.283185307179586) * rdt
    ref = torch.cat([torch.sin(ay), torch.cos(ay), torch.sin(ax),
                     torch.cos(ax)], dim=-1)
    assert feats.shape == (77, 64) and feats.dtype == torch.bfloat16
    # one bf16 ulp of values up to 1
    assert (feats.float() - ref).abs().max().item() <= 2 ** -8
    dd = torch.randn(154, 2, generator=g).to(dev)
    pts, outs = torch.empty_like(ct), torch.empty_like(ct)
    K.coord_update(ct, dd, pts, outs)
    inv = inverse_sigmoid(ct)
    torch.testing.assert_close(pts, torch.sigmoid(inv + dd[:77]), rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(outs, torch.sigmoid(inv + dd[77:]), rtol=0,
                               atol=1e-6)


def _small_decoder(dev, layers, bias, seed=1):
    from edgecape_tpu_torch.models.transformer import Decoder
    dec = _randomize(Decoder(64, 2, 96, layers, attn_bias=bias, max_hops=4,
                             num_feats=32, use_flash=True), dev, seed)
    with torch.no_grad():
        for br in dec.kpt_branches:          # small delta heads
            br.out.weight.mul_(0.1)
            br.out.bias.mul_(0.1)
    return dec


def _small_decoder_inputs(dev, b=3, k=13, hw=20, c=64):
    g = torch.Generator().manual_seed(11)
    valid = torch.rand(b, k, generator=g) > 0.3
    valid[:, 0] = True
    return ((torch.randn(b, k, c, generator=g) * 0.5).to(dev),
            (torch.rand(b, k, 2, generator=g) * 0.8 + 0.1).to(dev),
            (torch.randn(b, hw, c, generator=g) * 0.5).to(dev),
            (torch.randn(hw, c, generator=g) * 0.5).to(dev), valid.to(dev),
            torch.rand(b, k, k, 5, generator=g).to(dev),
            (torch.rand(b, 2, k, k, generator=g) / k).to(dev))


@pytest.mark.parametrize("bias", [True, False])
def test_fused_decoder_stack_matches_plain(dev, bias):
    """One layer alone against the plain version (coordinates in [0, 1]:
    2e-3 max, 2e-4 mean, a few bf16 ulps of a token through delta heads of
    about 0.01), then two layers against the layer chain."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    args = list(_small_decoder_inputs(dev))
    if not bias:
        args[5] = None
    kw = dict(num_heads=2, num_feats=32)
    with torch.no_grad():
        one = _small_decoder(dev, 1, bias)
        n0 = FD.stack_launches
        o, p = FD.fused_decoder_stack(*args, one, **kw)
        assert FD.stack_launches == n0 + 1
        ro, rp = FD.fused_decoder_stack_plain(*args, one, **kw)
        for a, r in ((o, ro), (p, rp)):
            assert a.shape == (1, 3, 13, 2) and a.dtype == torch.float32
            d = (a - r).abs()
            assert bool(torch.isfinite(a).all())
            assert d.max().item() <= 2e-3 and d.mean().item() <= 2e-4
        two = _small_decoder(dev, 2, bias, seed=2)
        x, ct, img, ipos, valid, hops, adj = args
        outs, pts = two.decode_stacked(
            x, img, kp_valid=valid, img_pos=ipos[None].expand(3, -1, -1),
            initial_proposals=ct, adj=adj, hop_stack=hops)
        n0 = FD.launches
        inter, points = two(x, img, kp_valid=valid,
                            img_pos=ipos[None].expand(3, -1, -1),
                            initial_proposals=ct, adj=adj, hop_stack=hops)
        assert FD.launches == n0 + 2
        d = (pts[-1] - points[-1]).abs()
        assert d.median().item() <= 1e-3 and d.max().item() <= 2e-2


def test_decoder_stack_weight_cache_follows_the_parameters(dev):
    """The prepared weights are rebuilt when a parameter is written (a
    load_state_dict) or replaced (a cast of the module)."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    args = _small_decoder_inputs(dev)
    kw = dict(num_heads=2, num_feats=32)
    with torch.no_grad():
        dec = _small_decoder(dev, 1, True)
        first, _ = FD.fused_decoder_stack(*args, dec, **kw)
        cached = dec._stack_cache[1]
        FD.fused_decoder_stack(*args, dec, **kw)
        assert dec._stack_cache[1] is cached          # reused
        other = _small_decoder(dev, 1, True, seed=5)
        dec.load_state_dict(other.state_dict())
        second, _ = FD.fused_decoder_stack(*args, dec, **kw)
        want, _ = FD.fused_decoder_stack(*args, other, **kw)
        assert dec._stack_cache[1] is not cached
        assert torch.equal(second, want) and not torch.equal(second, first)
        dec.to(torch.bfloat16)
        third, _ = FD.fused_decoder_stack(*args, dec, **kw)
        ref, _ = FD.fused_decoder_stack_plain(*args, dec, **kw)
        assert (third - ref).abs().max().item() <= 2e-3


@pytest.mark.parametrize("b,g,n,c,f,reps", [(6, 3, 70, 256, 192, 3),
                                            (4, 2, 264, 384, 128, 2),
                                            (8, 4, 13, 128, 64, 1)])
def test_mm_chain_matches_plain_and_fold_equals_loop(dev, b, g, n, c, f, reps):
    """Ragged row tiles (n not a multiple of 64) at the three widths: the
    kernel against the plain version within 2^-6 of the output's largest
    magnitude (bf16 roundings that flip and carry through the steps), loop
    and fold bit-equal, one launch counted per call."""
    from edgecape_tpu_torch.ops import mm_chain as MC
    bf = torch.bfloat16
    x = _rn(dev, b, n, c, seed=1).to(bf)
    w1 = _rn(dev, c, f, s=0.05, seed=2).to(bf)
    w2 = _rn(dev, f, c, s=0.05, seed=3).to(bf)
    n0 = MC.launches
    loop = MC.mm_chain(x, w1, w2, reps, g, False)
    fold = MC.mm_chain(x, w1, w2, reps, g, True)
    torch.cuda.synchronize()
    assert MC.launches == n0 + 2
    assert torch.equal(loop, fold)
    ref = MC.mm_chain_plain(x, w1, w2, reps, g, True).float()
    d = (fold.float() - ref).abs()
    assert bool(torch.isfinite(fold.float()).all())
    assert d.max().item() <= 2 ** -6 * ref.abs().max().item()
    assert torch.equal(MC.mm_chain(x, w1, w2, 0, g, True), x)
    with pytest.raises(ValueError):
        MC.mm_chain(x[..., :64].contiguous(), w1[:64], w2[:, :64], 1, g, True)
