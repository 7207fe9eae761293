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
