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
