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
import torch_threads  # noqa: F401  (caps torch's threads per worker)

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
    """At the model's width (vit_mlp_kernel takes C = 384), 111 rows."""
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    Block, DinoV2Config, _, _ = _modules()
    with torch.no_grad():
        blk = _randomize(Block(DinoV2Config()), dev)
        x = _rn(dev, 3, 37, 384).to(torch.bfloat16)
        _close(FV.fused_vit_block(x, blk, num_heads=6),
               FV.fused_vit_block_plain(x, blk, num_heads=6))


def test_fused_encoder_layers_and_stack_match_plain(dev):
    """Each layer of the stack against the plain layer on the kernel's own
    input (a near-tie in one layer's softmax would otherwise be amplified
    by the next), then the stack against the chain of layer launches. At
    the model's width (the post-attention kernel takes C = 256), 171 rows:
    one whole tile and a ragged one."""
    from edgecape_tpu_torch.ops import fused_encoder as FE
    _, _, _, EncoderLayer = _modules()
    with torch.no_grad():
        enc = [_randomize(EncoderLayer(256, 8, 384), dev, seed=s)
               for s in (1, 2)]
        tok = _rn(dev, 3, 57, 256).to(torch.bfloat16)
        pos = _rn(dev, 57, 256, seed=5)
        valid = _rn(dev, 3, 57, seed=6) > -0.5
        valid[:, 0] = True
        x = tok
        for layer in enc:
            y = FE.fused_encoder_layer(x, pos, valid, layer, num_heads=8)
            _close(y, FE.fused_encoder_layer_plain(x, pos, valid, layer,
                                                   num_heads=8))
            x = y
        assert torch.equal(FE.fused_encoder_stack(tok, pos, valid, enc,
                                                  num_heads=8), x)


def test_fused_decoder_layer_matches_plain(dev):
    from edgecape_tpu_torch.ops import fused_decoder as FD
    _, _, DecoderLayer, _ = _modules()
    with torch.no_grad():
        dec = _randomize(DecoderLayer(256, 8, 384), dev)
        kx = _rn(dev, 3, 13, 256).to(torch.bfloat16)
        qpos, img = _rn(dev, 3, 13, 256, seed=7), _rn(dev, 3, 20, 256, seed=8)
        ipos = _rn(dev, 20, 256, seed=9)
        kvalid = _rn(dev, 3, 13, seed=10) > -0.5
        kvalid[:, 0] = True
        bias = _rn(dev, 3, 8, 13, 13, seed=11)
        adj = _rn(dev, 3, 2, 13, 13, seed=12).abs() / 13
        args = (kx, qpos, img, ipos, kvalid, bias, adj, dec)
        _close(FD.fused_decoder_layer(*args, num_heads=8),
               FD.fused_decoder_layer_plain(*args, num_heads=8))


def _post_weights(dev, c, f, seed):
    """Seeded weights of the three post-attention kernels, as the ops
    prepare them."""
    g = torch.Generator().manual_seed(seed)

    def mat(o, i):
        return (torch.randn(o, i, generator=g) / math.sqrt(i)).to(
            dev, torch.bfloat16)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g)).to(dev)

    return {"wo": mat(c, c), "bo": vec(c), "g1": vec(c, 1.0),
            "be1": vec(c), "w1": mat(f, c), "b1": vec(f), "w2": mat(c, f),
            "b2": vec(c), "g2": vec(c, 1.0), "be2": vec(c),
            "wso": mat(c, c), "bso": vec(c), "wcq_x": mat(2 * c, c),
            "wcq_p": mat(2 * c, c), "bcq": vec(2 * c),
            "wco": mat(2 * c, 2 * c), "bco": vec(2 * c),
            "wch": mat(c, 2 * c), "bch": vec(c), "wg": mat(2 * f, c),
            "bg": vec(2 * f), "wf": mat(c, f), "bf": vec(c),
            "g3": vec(c, 1.0), "be3": vec(c)}


def _ln(x, w, g, b):
    from edgecape_tpu_torch.ops import plain
    return plain.layer_norm(x, w[g], w[b], 1e-5)


# rows of the post-attention kernels: the eval chunk's encoder (510 x 356)
# and decoder (510 x 100) rows, ragged tile counts, fewer rows than a tile
POST_ROWS = [510 * 356, 510 * 100, 300, 129, 1]


@pytest.mark.parametrize("rows", POST_ROWS)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_enc_post_matches_plain(dev, rows, out_dtype):
    """enc_post against the plain formulas (tests/test_torch_fused_post.py
    holds its order of operations against the TPU kernel's): y in either
    type and the next layer's src = bf16(bf16(y) + pos)."""
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops import plain
    c, f, n_tok = 256, 384, 356
    w = _post_weights(dev, c, f, seed=30)
    att = _rn(dev, rows, c, seed=31).to(torch.bfloat16)
    src = _rn(dev, rows, c, seed=32).to(torch.bfloat16)
    pos = _rn(dev, n_tok, c, seed=33).to(torch.bfloat16)
    n0 = K.launches["enc_post_kernel"]
    y, nxt = K.enc_post(att, src, w, eps=1e-5, out_dtype=out_dtype, pos=pos)
    assert K.launches["enc_post_kernel"] == n0 + 1
    x = _ln(src.float() + plain.linear(att, w["wo"], w["bo"]), w, "g1", "be1")
    h = torch.relu(plain.linear(x, w["w1"], w["b1"]))
    ref = _ln(x + plain.linear(h, w["w2"], w["b2"]), w, "g2", "be2")
    assert y.dtype == out_dtype
    _close(y, ref)
    want = (y.to(torch.bfloat16).float()
            + pos.float().repeat(-(-rows // n_tok), 1)[:rows]).to(
        torch.bfloat16)
    assert torch.equal(nxt, want)


@pytest.mark.parametrize("rows", POST_ROWS[1:])
def test_dec_post_self_matches_plain(dev, rows):
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops import plain
    c = 256
    w = _post_weights(dev, c, 384, seed=40)
    att, xb, qpos = (_rn(dev, rows, c, seed=41 + i).to(torch.bfloat16)
                     for i in range(3))
    x1, q2 = K.dec_post_self(att, xb, qpos, w, eps=1e-5)
    ref = _ln(xb.float() + plain.linear(att, w["wso"], w["bso"]), w, "g1",
              "be1")
    _close(x1, ref)
    qref = plain.linear(torch.cat([x1, qpos.float()], -1),
                        torch.cat([w["wcq_x"], w["wcq_p"]], -1), w["bcq"])
    assert q2.dtype == torch.bfloat16 and q2.shape == (rows, 2 * c)
    _close(q2, qref)


@pytest.mark.parametrize("b,k", [(510, 100), (3, 100), (2, 13), (1, 128),
                                 (133, 1), (1, 129), (2, 300)])
@pytest.mark.parametrize("adj_dtype", [torch.float32, torch.bfloat16])
def test_dec_post_cross_matches_plain(dev, b, k, adj_dtype):
    """One batch row of K keypoints a tile, padded to 128 rows: the
    adjacency's padding must contribute nothing. Above 128 keypoints the
    cross layer's wide pair (ceil(K / 64) key boxes, a ragged last one)
    on the same weights: the stage-3 GCN of 384 is whole 128-wide chunks."""
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops import plain
    c, f = 256, 384
    w = _post_weights(dev, c, f, seed=50)
    att2 = _rn(dev, b, k, 2 * c, seed=51).to(torch.bfloat16)
    x1 = _rn(dev, b * k, c, seed=52)
    adj = (_rn(dev, b, 2, k, k, seed=53).abs() / k).to(adj_dtype)
    out = K.dec_post_cross(att2, x1, adj, w, eps=1e-5,
                           out_dtype=torch.bfloat16)
    o2 = plain.bf16(plain.linear(att2, w["wco"], w["bco"]))
    x2 = _ln(x1.view(b, k, c) + plain.linear(o2, w["wch"], w["bch"]), w,
             "g2", "be2")
    y = plain.bf16(plain.linear(x2, w["wg"], w["bg"]))
    a = plain.bf16(adj.float())
    m = torch.matmul(a[:, 0], y[..., :f]) + torch.matmul(a[:, 1], y[..., f:])
    ref = _ln(x2 + plain.linear(torch.relu(m), w["wf"], w["bf"]), w, "g3",
              "be3")
    _close(out.view(b, k, c), ref)


def test_post_kernels_refuse_what_they_do_not_take(dev):
    from edgecape_tpu_torch.ops import kernels as K
    w = _post_weights(dev, 256, 384, seed=60)
    att = _rn(dev, 10, 256).to(torch.bfloat16)
    with pytest.raises(ValueError):                  # fp32 operand
        K.enc_post(att.float(), att, w, eps=1e-5, out_dtype=torch.float32)
    with pytest.raises(ValueError):                  # adjacency not [B, 2, K, K]
        K.dec_post_cross(_rn(dev, 1, 129, 512).to(torch.bfloat16),
                         _rn(dev, 129, 256), _rn(dev, 1, 2, 129, 128), w,
                         eps=1e-5, out_dtype=torch.float32)
    with pytest.raises(ValueError):                  # strided src
        K.dec_post_self(att, _rn(dev, 10, 512).to(torch.bfloat16)[:, :256],
                        att, w, eps=1e-5)


def test_encoder_stack_and_decoder_layer_launches(dev):
    """The stack of three layers in 1 + 3 x 3 kernels (add_pos, then qkv
    GEMM, attention, enc_post_kernel a layer), one decoder layer in 8, no
    weight cast per call, no GEMM on the thread-copy mainloop."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import fused_encoder as FE
    from edgecape_tpu_torch.ops import kernels as K
    _, _, DecoderLayer, EncoderLayer = _modules()
    bf = torch.bfloat16
    with torch.no_grad():
        enc = [_randomize(EncoderLayer(256, 8, 384), dev, seed=s)
               for s in (1, 2, 3)]
        tok = _rn(dev, 4, 70, 256).to(bf)
        pos = _rn(dev, 70, 256, seed=5).to(bf)
        valid = _rn(dev, 4, 70, seed=6) > -0.5
        names = _kernel_names(lambda: FE.fused_encoder_stack(
            tok, pos, valid, enc, num_heads=8))
        assert len(names) == 10, names
        assert sum("enc_post_kernel" in n for n in names) == 3, names
        dec = _randomize(DecoderLayer(256, 8, 384), dev)
        kx, qpos = _rn(dev, 4, 100, 256).to(bf), _rn(dev, 4, 100, 256).to(bf)
        img = _rn(dev, 4, 356, 256, seed=7).to(bf)[:, :256]   # a slice
        ipos = _rn(dev, 256, 256, seed=8).to(bf)
        kvalid = _rn(dev, 4, 100, seed=9) > -0.5
        kvalid[:, 0] = True
        bias = _rn(dev, 4, 8, 100, 100, seed=10)
        adj = _rn(dev, 4, 2, 100, 100, seed=11).abs() / 100
        n0 = dict(K.launches)
        names = _kernel_names(lambda: FD.fused_decoder_layer(
            kx, qpos, img, ipos, kvalid, bias, adj, dec, num_heads=8))
        assert K.launches["gemm_kernel"] == n0["gemm_kernel"]
        assert K.launches["gemm_tma_kernel"] == n0["gemm_tma_kernel"] + 2 * 4
        assert len(names) == 8, names
        assert sum("dec_post" in n for n in names) == 2, names


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
    """Head dims above 128 are refused; any token count is taken at head
    dims up to 128 (past what a block holds the streaming kernels; head
    dims below 128 run padded to 32, 64 or 128): 513 tokens at head dim
    128 run the streaming pair's head-dim-128 instances and match autograd
    through the plain version."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    with pytest.raises(ValueError):
        FA.flash_mha_train(*(_rn(dev, 1, 8, 2, 129) for _ in range(3)))
    q, k, v, g, valid, _ = _train_case(dev, 1, 513, 1, 128, True, False)
    before = dict(K.launches)
    out, grads = _grads(FA.flash_mha_train, q, k, v, g, valid, None)
    for name in ("train_fwd_long_kernel<128>", "train_bwd_q_long_kernel<128>",
                 "train_bwd_k_long_kernel<128>"):
        assert K.launches[name] == before[name] + 1, name
    ref, rgrads = _grads(FA.flash_mha_train_plain, q, k, v, g, valid, None)
    _close(out, ref)
    for a, r in zip(grads, rgrads):
        _close(a, r)


# call sites of a training step (batch cut to 2), mask / bias / both
BWD_SITES = [(2, 356, 8, 32), (2, 100, 8, 32)]


@pytest.mark.parametrize("shape", BWD_SITES)
@pytest.mark.parametrize("form", ["mask", "bias", "both"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_train_backward_matches_plain_at_call_site_shapes(dev, shape, form,
                                                          rate):
    """dq, dk, dv, dbias of the two backward kernels against autograd
    through the plain version fed the kernels' own keep mask, and two runs
    at one seed bit for bit."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, n, h, d = shape
    case = _train_case(dev, *shape, form != "bias", form != "mask")
    gen = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
    kw, pkw = {}, {}
    if rate:
        seed = FA.dropout_seed(gen(), dev)
        keep = K.dropout_mask(seed, rate, b * h, n, n).reshape(b, h, n, n)
        kw = {"dropout_rate": rate, "generator": gen()}
        pkw = {"dropout_rate": rate, "keep": keep}
    out, grads = _grads(FA.flash_mha_train, *case, **kw)
    ref, rgrads = _grads(FA.flash_mha_train_plain, *case, **pkw)
    _close(out, ref)
    assert len(grads) == (4 if form != "mask" else 3)
    for a, r in zip(grads, rgrads):
        _close(a, r)
    if rate:
        kw["generator"] = gen()
    _, again = _grads(FA.flash_mha_train, *case, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


@pytest.mark.parametrize("nk", [1, 7, 100, 257, 356, 512])
@pytest.mark.parametrize("d", [32, 64])
def test_train_backward_key_counts(dev, nk, d):
    """Ragged and long key rows (one pass up to 128 keys, two above), with
    another query count than key count, mask, bias and dropout."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, nq, h, rate = 2, 45, 2, 0.25
    q, g = _rn(dev, b, nq, h, d, seed=30), _rn(dev, b, nq, h, d, seed=31)
    k, v = _rn(dev, b, nk, h, d, seed=32), _rn(dev, b, nk, h, d, seed=33)
    valid = _rn(dev, b, nk, seed=34) > -0.3
    valid[:, 0] = True
    bias = _rn(dev, b, h, nq, nk, seed=35)
    gen = torch.Generator(device=dev).manual_seed(9)
    seed = FA.dropout_seed(torch.Generator(device=dev).manual_seed(9), dev)
    keep = K.dropout_mask(seed, rate, b * h, nq, nk).reshape(b, h, nq, nk)
    out, grads = _grads(FA.flash_mha_train, q, k, v, g, valid, bias,
                        dropout_rate=rate, generator=gen)
    ref, rgrads = _grads(FA.flash_mha_train_plain, q, k, v, g, valid, bias,
                         dropout_rate=rate, keep=keep)
    _close(out, ref)
    for a, r in zip(grads, rgrads):
        _close(a, r)


def test_train_backward_forced_two_pass_equals_plain(dev):
    """The two-pass query-major kernel where one pass would do."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, n, h, d = 2, 100, 8, 32
    q, k, v, g, valid, bias = _train_case(dev, b, n, h, d, True, True)
    flat = lambda t: t.reshape(b, n, h * d)  # noqa: E731
    _, stats = K.attention_train_fwd(flat(q), flat(k), flat(v), num_heads=h,
                                     scale=d ** -0.5, key_valid=valid,
                                     bias=bias)
    got = {}
    for tiles in (K.ATT_ROW16, K.ATT_CH16):
        plan = K.attention_bwd_plan(n, n, d, chunk_tiles=tiles)
        got[tiles] = K.attention_train_bwd(
            flat(q), flat(k), flat(v), flat(g), stats, num_heads=h,
            scale=d ** -0.5, key_valid=valid, bias=bias, plan=plan)
    _, rgrads = _grads(FA.flash_mha_train_plain, q, k, v, g, valid, bias)
    for tiles, grads in got.items():
        for a, r in zip(grads, rgrads):
            _close(a.reshape(r.shape), r)


def test_train_backward_without_dbias_and_with_masked_rows(dev):
    """A bias that needs no gradient gets none, and the other gradients do
    not change; rows with every key masked give zero gradients with
    dropout on."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    q, k, v, g, valid, bias = _train_case(dev, 2, 19, 2, 32, True, True)
    _, with_db = _grads(FA.flash_mha_train, q, k, v, g, valid, bias)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FA.flash_mha_train(*leaves, valid, bias)
    without = torch.autograd.grad(out, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(without, with_db[:3]))
    valid[1] = False
    gen = torch.Generator(device=dev).manual_seed(3)
    out, grads = _grads(FA.flash_mha_train, q, k, v, g, valid, bias,
                        dropout_rate=0.1, generator=gen)
    assert bool((out[1] == 0).all())
    assert all(bool(torch.isfinite(t).all()) and bool((t[1] == 0).all())
               for t in grads)


def test_train_backward_refuses_a_plan_that_does_not_cover_the_shape(dev):
    from edgecape_tpu_torch.ops import kernels as K
    b, n, h, d = 1, 100, 2, 32
    q = _rn(dev, b, n, h * d)
    _, stats = K.attention_train_fwd(q, q, q, num_heads=h, scale=1.0)
    good = K.attention_bwd_plan(n, n, d)
    for key, value in (("q_split", 1), ("k_split", 1), ("q_warps", 9),
                       ("q_smem_bytes", 1024), ("k_smem_bytes", 1024),
                       ("chunk_tiles", 3)):
        plan = dict(good, **{key: value})
        with pytest.raises(RuntimeError):
            K.attention_train_bwd(q, q, q, q, stats, num_heads=h, scale=1.0,
                                  plan=plan)
    short = K.attention_bwd_plan(300, 300, d)
    with pytest.raises(RuntimeError):
        K.attention_train_bwd(
            *(_rn(dev, 1, 300, h * d) for _ in range(4)),
            K.attention_train_fwd(*(_rn(dev, 1, 300, h * d)
                                    for _ in range(3)), num_heads=h,
                                  scale=1.0)[1],
            num_heads=h, scale=1.0,
            plan=dict(short, chunk_tiles=K.ATT_ROW16))


# ------------------------------------------------------------- the GEMM
def _gemm_case(dev, spec, rows=1310):
    """A bench shape with M cut to `rows` (ragged against both tile
    heights), its operands and its float64 reference."""
    from edgecape_tpu_torch.tools import bench_gemm as BG
    name, z, m, n, k, b_nk, epi, dtype = spec
    spec = (name, None if z is None else 3, min(m, rows), n, k, b_nk, epi,
            dtype)
    a, b, kw = BG.make_case(spec, dev)
    ref = BG.reference(a, b, b_nk, kw["bias"], kw["pre"], kw["act"],
                       kw["res"], kw["ls"])
    return spec, a, b, kw, ref


def _gemm_specs():
    from edgecape_tpu_torch.tools import bench_gemm as BG
    return BG.SHAPES


@pytest.mark.parametrize("index", range(14))
def test_gemm_at_path_shapes_both_mainloops(dev, index):
    """Every path shape of tools/bench_gemm.py (M cut to 1310 rows): the
    mainloop the dispatch picks and, where the operands allow TMA, the
    other one too, against the float64 product of the bf16 operands."""
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.tools import bench_gemm as BG
    specs = _gemm_specs()
    assert len(specs) == 14
    spec, a, b, kw, ref = _gemm_case(dev, specs[index])
    b_nk, dtype = spec[5], spec[7]
    n0 = dict(K.launches)
    out = K.gemm(a, b, b_nk=b_nk, out_dtype=dtype, **kw)
    picked = "tma" if K.launches["gemm_tma_kernel"] > n0["gemm_tma_kernel"] \
        else "copy"
    assert BG.check(out, ref)[1], (spec[0], picked)
    other = K.gemm(a, b, b_nk=b_nk, out_dtype=dtype, mainloop=K.GEMM_COPY,
                   **kw)
    assert BG.check(other, ref)[1], (spec[0], "copy")
    if picked == "copy":
        with pytest.raises(RuntimeError):
            K.gemm(a, b, b_nk=b_nk, out_dtype=dtype, mainloop=K.GEMM_TMA,
                   **kw)


@pytest.mark.parametrize("m,n,k", [(300, 33, 40), (129, 160, 72),
                                   (1, 128, 64), (257, 250, 200),
                                   (640, 384, 8)])
@pytest.mark.parametrize("b_nk", [True, False])
@pytest.mark.parametrize("epi", ["bias", "gelu", "relu", "pre", "res_ls",
                                 "none"])
def test_gemm_ragged_edges_each_epilogue(dev, m, n, k, b_nk, epi):
    """Ragged M, N and K (tiles cut by the tensor map's zero fill, the
    epilogue's checked form), both forms of B, every epilogue, fp32 and
    bf16 outputs; the TMA mainloop wherever the row strides allow it."""
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.tools import bench_gemm as BG
    if not b_nk and n % 8:
        n += 8 - n % 8          # rows of B as [K, N] on 16 bytes
    for dtype in (torch.float32, torch.bfloat16):
        spec = ("ragged", None, m, n, k, b_nk, epi, dtype)
        a, b, kw = BG.make_case(spec, dev)
        ref = BG.reference(a, b, b_nk, kw["bias"], kw["pre"], kw["act"],
                           kw["res"], kw["ls"])
        n0 = K.launches["gemm_tma_kernel"]
        out = K.gemm(a, b, b_nk=b_nk, out_dtype=dtype, **kw)
        assert K.launches["gemm_tma_kernel"] == n0 + 1
        assert BG.check(out, ref)[1]
        copy = K.gemm(a, b, b_nk=b_nk, out_dtype=dtype,
                      mainloop=K.GEMM_COPY, **kw)
        assert BG.check(copy, ref)[1]


def test_gemm_strided_out_shared_batch_operand_and_odd_views(dev):
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.tools import bench_gemm as BG
    bf = torch.bfloat16
    a = _rn(dev, 5, 200, 96).to(bf)                   # batched A
    w = (_rn(dev, 160, 96, seed=1) / 10).to(bf)       # shared [N, K]
    pre = _rn(dev, 200, 160, seed=2)                  # shared across batch
    ref = BG.reference(a, w, True, None, pre, K.ACT_NONE, None, None)
    big = torch.full((5, 200, 512), 7.0, device=dev)
    out = K.gemm(a, w, b_nk=True, pre=pre, out=big[..., 64:224])
    assert out.data_ptr() == big[..., 64:224].data_ptr()
    assert BG.check(big[..., 64:224], ref)[1]
    assert bool((big[..., :64] == 7).all()) and bool(
        (big[..., 224:] == 7).all())
    # an odd column offset: the pairs of the output are not aligned, the
    # epilogue stores element by element
    odd = torch.full((5, 200, 512), 7.0, device=dev, dtype=bf)
    K.gemm(a, w, b_nk=True, pre=pre, out=odd[..., 3:163])
    assert BG.check(odd[..., 3:163], ref)[1]
    assert bool((odd[..., :3] == 7).all()) and bool((odd[..., 163:] == 7).all())
    # operands as views: A a column slice of a wider buffer (TMA), and one
    # whose base is off 16 bytes (the thread-copy loader)
    wide = _rn(dev, 200, 256, seed=3).to(bf)
    for lo, loop in ((64, "gemm_tma_kernel"), (4, "gemm_kernel")):
        n0 = dict(K.launches)
        got = K.gemm(wide[:, lo:lo + 96], w, b_nk=True,
                     out_dtype=torch.float32)
        assert K.launches[loop] == n0[loop] + 1
        assert BG.check(got, BG.reference(wide[:, lo:lo + 96], w, True, None,
                                          None, K.ACT_NONE, None, None))[1]


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
    """At the width vit_mlp_kernel takes (C 384, F 1536), 111 rows."""
    from edgecape_tpu_torch.ops import fused_mlp as FM
    _, mlp = _half_args(dev, 384, 1536)
    x = _rn(dev, 3, 37, 384).to(dtype)
    n0 = FM.launches
    out = FM.fused_ln_mlp(x, *mlp)
    assert out.dtype == dtype and FM.launches == n0 + 1
    _close(out, FM.fused_ln_mlp_plain(x, *mlp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attn_block_matches_plain(dev, dtype):
    """At the model's width (the ViT attention kernels take C = 384 in 6
    heads), 111 rows."""
    from edgecape_tpu_torch.ops import fused_attn_block as FB
    attn, _ = _half_args(dev, 384, 1536)
    x = _rn(dev, 3, 37, 384).to(dtype)
    n0 = FB.launches
    out = FB.fused_attn_block(x, *attn, num_heads=6)
    assert out.dtype == dtype and FB.launches == n0 + 1
    _close(out, FB.fused_attn_block_plain(x, *attn, num_heads=6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_vit_block2_bit_equal_to_two_blocks(dev, dtype):
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    Block, DinoV2Config, _, _ = _modules()
    cfg = DinoV2Config()
    with torch.no_grad():
        a, b = _randomize(Block(cfg), dev, 1), _randomize(Block(cfg), dev, 2)
        x = _rn(dev, 3, 37, 384).to(dtype)
        n1, n2 = FV.launches, FV.launches2
        pair = FV.fused_vit_block2(x, a, b, num_heads=6)
        assert (FV.launches, FV.launches2) == (n1, n2 + 1)
        two = FV.fused_vit_block(FV.fused_vit_block(x, a, num_heads=6), b,
                                 num_heads=6)
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


def _bias_attention_operands(dev, b, n, nhop, hid, seed=0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3 * 256, generator=g).to(dev).to(torch.bfloat16)
    hops = torch.rand(b, n, n, nhop, generator=g).to(dev).to(torch.bfloat16)
    mlp = (torch.randn(nhop, hid, generator=g).to(dev),
           (torch.randn(hid, generator=g) * 0.1).to(dev),
           (torch.randn(hid, 8, generator=g) / math.sqrt(hid)).to(dev),
           (torch.randn(8, generator=g) * 0.1).to(dev))
    valid = (torch.rand(b, n, generator=g) > 0.3).to(dev)
    valid[:, 0] = True
    return qkv, valid, hops, mlp


@pytest.mark.parametrize("b,n,heads,d", [(3, 133, 8, 32), (510, 133, 8, 32),
                                         (510, 136, 8, 32), (60, 145, 8, 64),
                                         (2, 256, 8, 32), (2, 300, 8, 64),
                                         (2, 300, 16, 32), (1, 150, 16, 128),
                                         (2, 137, 3, 25)])
def test_bias_attention_above_128_keys_matches_plain(dev, b, n, heads, d):
    """bias_attn_long_kernel: the stage-3 heads at K 133 and Halpe's 136
    (few rows, the eval chunk's 510), whole and ragged key tiles, 512
    channels, 16 heads (two a warp; 16-key tiles at head dim 128), a padded
    head dim; one launch counted, within a bf16 ulp of the plain version,
    whose probabilities it rounds at the same point; the first and the last
    batch row alone give the same bits."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    g = torch.Generator().manual_seed(n + heads)
    c = heads * d
    qkv = torch.randn(b, n, 3 * c, generator=g).to(dev).to(torch.bfloat16)
    hops = torch.rand(b, n, n, 5, generator=g).to(dev).to(torch.bfloat16)
    mlp = (torch.randn(5, 12, generator=g).to(dev),
           (torch.randn(12, generator=g) * 0.1).to(dev),
           (torch.randn(12, heads, generator=g) / math.sqrt(12)).to(dev),
           (torch.randn(heads, generator=g) * 0.1).to(dev))
    valid = (torch.rand(b, n, generator=g) > 0.3).to(dev)
    valid[:, 0] = True
    n0 = K.launches["bias_attn_long_kernel"]
    out = K.bias_attention(qkv, valid, hops, mlp, num_heads=heads)
    assert K.launches["bias_attn_long_kernel"] == n0 + 1
    ref = FD.bias_attention_plain(qkv, valid, hops, mlp, num_heads=heads)
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, c)
    _close(out, ref)
    d_ = (out.float() - ref).abs()
    assert d_.max().item() <= 2 ** -6 and d_.mean().item() <= 1e-4
    # rows independent of their batch place: the first and the last row
    # alone (copies, so that their operands stay 16-byte aligned), bit-equal
    for i in (0, b - 1):
        one = K.bias_attention(qkv[i:i + 1].clone(), valid[i:i + 1],
                               hops[i:i + 1].clone(), mlp, num_heads=heads)
        assert torch.equal(one, out[i:i + 1]), i


@pytest.mark.parametrize("c", [100, 256, 512])
@pytest.mark.parametrize("k", [133, 300, 700])
def test_dec_wide_plan_rings_above_128_keypoints_are_the_kernels(dev, c, k):
    """Above 128 keypoints the gcn kernel's adjacency window of
    DEC_ADJ_LONG boxes: the plan's slots and shared memory are those of
    csrc/dec_wide.cu's launch; K 700 walks its boxes a window at a
    time."""
    from edgecape_tpu_torch.ops import kernels as K
    assert K.dec_wide_card_rings(c, k) == K.dec_wide_rings(c, k)


@pytest.mark.parametrize("c,f", [(256, 384), (256, 320), (200, 300)])
@pytest.mark.parametrize("b,k", [(3, 133), (1, 700)])
def test_cross_layer_above_128_keypoints_matches_plain(dev, c, f, b, k):
    """dec_post_cross above 128 keypoints on a layer's prepared weights
    (ops/fused_decoder.py cross_weights: an FFN of 320 padded to whole
    chunks at 256 channels), some keypoints of each batch row invalid
    (zero adjacency rows and columns), against post_cross_plain; at K 700
    the gcn kernel reloads its adjacency boxes a window at a time."""
    from edgecape_tpu_torch.models.transformer import DecoderLayer
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    layer = _randomize(DecoderLayer(c, 8, f), dev, seed=c + f)
    w = FD.cross_weights(layer, FD._prepare(layer), k)
    g = torch.Generator().manual_seed(k)
    att2 = (torch.randn(b, k, 2 * c, generator=g)).to(dev).to(torch.bfloat16)
    x1 = torch.randn(b * k, c, generator=g).to(dev)
    valid = torch.rand(b, k, generator=g) > 0.2
    keep = (valid[:, None, :, None] & valid[:, None, None, :]).float()
    adj = (torch.rand(b, 2, k, k, generator=g) / k * keep).to(dev)
    n0 = {n: K.launches[n] for n in ("dec_post_cross_wide_kernel",
                                     "dec_post_gcn_wide_kernel")}
    with torch.no_grad():
        out = K.dec_post_cross(att2, x1, adj, w, eps=1e-5,
                               out_dtype=torch.float32)
        ref = FD.post_cross_plain(att2, x1.view(b, k, c), adj, layer)
    assert all(K.launches[n] == v + 1 for n, v in n0.items())
    _close(out.view(b, k, c), ref)


def test_decoder_stack_launches_at_133_keypoints(dev):
    """At 133 keypoints one call of the three-layer stack is 3 + 10 x 3
    kernels: the bias attention is bias_attn_long_kernel and the cross
    layer the wide pair (dec_post_cross_wide_kernel,
    dec_post_gcn_wide_kernel); no resident bias attention, no
    dec_post_cross_kernel; one layer alone against the plain version to
    the bound of test_fused_decoder_stack_matches_plain."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    dec = _small_decoder(dev, 3, True, c=256, heads=8, ffn=384, nf=128)
    args = [t.to(torch.bfloat16) if t.is_floating_point() and i != 1 else t
            for i, t in enumerate(_small_decoder_inputs(dev, k=133, c=256))]
    kw = dict(num_heads=8, num_feats=128)
    with torch.no_grad():
        names = _kernel_names(lambda: FD.fused_decoder_stack(*args, dec, **kw))
        o, p = FD.fused_decoder_stack(*args, dec, **kw)
        ro, rp = FD.fused_decoder_stack_plain(*args, dec, **kw)
    assert len(names) == 3 + 10 * 3, names
    for kern in ("bias_attn_long_kernel", "dec_post_cross_wide_kernel",
                 "dec_post_gcn_wide_kernel", "kpt_head_kernel",
                 "dec_post_self_kernel"):
        assert sum(kern in n for n in names) == 3, kern
    assert not any("bias_attn_kernel" in n or "dec_post_cross_kernel" in n
                   for n in names)
    d0 = torch.cat([(o[0] - ro[0]).abs().flatten(),
                    (p[0] - rp[0]).abs().flatten()])
    assert d0.max().item() <= 2e-3 and d0.mean().item() <= 2e-4


@pytest.mark.parametrize("b,n,nhop,hid", [(3, 100, 5, 12), (2, 37, 5, 12),
                                          (300, 100, 5, 12), (1, 128, 8, 32),
                                          (2, 13, 3, 7)])
def test_bias_attention_matches_plain(dev, b, n, nhop, hid):
    """The Markov bias formed once for all heads in the kernel against the
    plain version (the bias by PyTorch, then plain attention): ragged K,
    a split of query tiles over blocks (small B) and none (B 300), the
    vector and element hop loads, a key mask; one launch counted."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    qkv, valid, hops, mlp = _bias_attention_operands(dev, b, n, nhop, hid)
    n0 = K.launches["bias_attn_kernel"]
    out = K.bias_attention(qkv, valid, hops, mlp, num_heads=8)
    assert K.launches["bias_attn_kernel"] == n0 + 1
    ref = FD.bias_attention_plain(qkv, valid, hops, mlp, num_heads=8)
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, 256)
    _close(out, ref)
    # the two sum the MLP in another order: at most a bf16 ulp of an output
    d_ = (out.float() - ref).abs()
    assert d_.max().item() <= 2 ** -7 and d_.mean().item() <= 1e-4
    with pytest.raises(ValueError):
        K.bias_attention(qkv[..., :384].contiguous(), valid, hops, mlp,
                         num_heads=4)


def test_kpt_head_matches_plain(dev):
    """The final norm, three GELU products, the N = 2 head and the
    coordinate update in one kernel against the plain version, over
    ragged row counts (a partial 64-row tile) and clipped coordinates."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    g = torch.Generator().manual_seed(4)

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)
    fn = (1.0 + rn(256, s=0.1), rn(256, s=0.1))
    kpt = [(rn(256, 256, s=1 / 16).to(torch.bfloat16), rn(256, s=0.1))
           for _ in range(3)]
    kow, kob = rn(2, 256, s=0.02).to(torch.bfloat16), rn(2, s=0.02)
    for r in (39, 64, 5100):
        x = rn(r, 256).to(torch.bfloat16)
        ct = torch.rand(r, 2, generator=g).to(dev)
        ct[0] = torch.tensor([0.0, 1.0])
        pts, outs = torch.empty_like(ct), torch.empty_like(ct)
        n0 = K.launches["kpt_head_kernel"]
        K.kpt_head(x, ct, fn, kpt, kow, kob, pts, outs, eps=1e-5)
        assert K.launches["kpt_head_kernel"] == n0 + 1
        rp, ro = FD.kpt_head_plain(x, ct, fn, kpt, kow, kob, eps=1e-5)
        for a, ref in ((pts, rp), (outs, ro)):
            d = (a - ref).abs()
            assert bool(torch.isfinite(a).all())
            # coordinates in [0, 1], delta heads of 0.02: bf16 flips of the
            # hidden move them by about 1e-5
            assert d.max().item() <= 2e-4 and d.mean().item() <= 1e-5


# The attention forward kernels at the shapes the eval and training paths
# give them (tools/bench_attention.py SHAPES), at a batch cut to 3: name,
# Nq, Nk, heads, head dim, key mask, bias.
ATTN_SHAPES = [("vit", 257, 257, 6, 64, False, False),
               ("encoder", 356, 356, 8, 32, True, False),
               ("decoder self", 100, 100, 8, 32, True, True),
               ("decoder cross", 100, 256, 8, 64, False, False),
               ("skeleton", 100, 100, 8, 32, True, False)]


def _attn_operands(dev, b, nq, nk, h, d, dtype, mask, bias, seed=0):
    """q, k, v as strided views of fused projections, a bool key mask with
    one fully valid first key, an fp32 bias."""
    g = torch.Generator().manual_seed(seed)
    c = h * d
    if nq == nk:
        qkv = torch.randn(b, nq, 3 * c, generator=g).to(dev).to(dtype)
        q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    else:
        q = torch.randn(b, nq, c, generator=g).to(dev).to(dtype)
        kv = torch.randn(b, nk, 2 * c, generator=g).to(dev).to(dtype)
        k, v = kv[..., :c], kv[..., c:]
    valid = None
    if mask:
        valid = (torch.rand(b, nk, generator=g) > 0.3).to(dev)
        valid[:, 0] = True
    bt = torch.randn(b, h, nq, nk, generator=g).to(dev) if bias else None
    return q, k, v, valid, bt


def _plain_attention(q, k, v, valid, bias, h, d):
    from edgecape_tpu_torch.ops import plain
    kb = None if valid is None else plain.key_bias(valid)
    return plain.attention(q, k, v, num_heads=h, scale=d ** -0.5, kb=kb,
                           bias=bias)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: s[0])
def test_attention_matches_plain_at_path_shapes(dev, shape, dtype):
    """bf16 and fp32 operands, strided QKV views, a new output and a
    caller's strided `out=` buffer of either dtype."""
    from edgecape_tpu_torch.ops import kernels as K
    _, nq, nk, h, d, mask, bias = shape
    q, k, v, valid, bt = _attn_operands(dev, 3, nq, nk, h, d, dtype, mask,
                                        bias)
    ref = _plain_attention(q, k, v, valid, bt, h, d)
    out = K.attention(q, k, v, num_heads=h, scale=d ** -0.5, key_valid=valid,
                      bias=bt)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    _close(out, ref)
    for odt in (torch.bfloat16, torch.float32):
        buf = torch.zeros(3, nq, 2 * h * d + 8, dtype=odt, device=dev)
        view = buf[..., 8:8 + h * d]
        got = K.attention(q, k, v, num_heads=h, scale=d ** -0.5,
                          key_valid=valid, bias=bt, out=view)
        assert got.data_ptr() == view.data_ptr()
        assert torch.equal(view.float(), out.float())
        assert not buf[..., :8].any() and not buf[..., 8 + h * d:].any()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("nk", [1, 7, 100, 257, 356, 512])
def test_attention_key_counts_and_forced_two_pass(dev, nk, d):
    """Ragged key counts on both sides of the one-pass limit; the two-pass
    form, forced where one pass is the default, also matches the plain
    version."""
    from edgecape_tpu_torch.ops import kernels as K
    h, nq = 2, 45
    q, k, v, valid, bt = _attn_operands(dev, 2, nq, nk, h, d, torch.bfloat16,
                                        True, True, seed=nk)
    ref = _plain_attention(q, k, v, valid, bt, h, d)
    out = K.attention(q, k, v, num_heads=h, scale=d ** -0.5, key_valid=valid,
                      bias=bt)
    _close(out, ref)
    plan = K.attention_plan(nq, nk, d)
    if plan["one_pass"]:
        two = K.attention(q, k, v, num_heads=h, scale=d ** -0.5,
                          key_valid=valid, bias=bt,
                          plan=K.attention_plan(nq, nk, d, chunk_tiles=2))
        _close(two, ref)


def test_attention_fully_masked_row_gives_zero(dev):
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    for nk, d in ((100, 32), (257, 64)):
        q, k, v, _, _ = _attn_operands(dev, 2, 33, nk, 2, d, torch.bfloat16,
                                       False, False)
        valid = torch.ones(2, nk, dtype=torch.bool, device=dev)
        valid[1] = False
        out = K.attention(q, k, v, num_heads=2, scale=d ** -0.5,
                          key_valid=valid)
        assert bool(torch.isfinite(out).all()) and not out[1].any()
        assert out[0].any()
        qf, kf, vf = (t.float().reshape(2, -1, 2, d) for t in (q, k, v))
        tr = FA.flash_mha_train(qf, kf, vf, valid)
        assert bool(torch.isfinite(tr).all()) and not tr[1].any()


def test_attention_refuses_a_plan_that_does_not_cover_the_shape(dev):
    from edgecape_tpu_torch.ops import kernels as K
    q, k, v, _, _ = _attn_operands(dev, 2, 100, 100, 2, 32, torch.bfloat16,
                                   False, False)
    plan = K.attention_plan(100, 100, 32)
    for bad in (dict(plan, q_split=1), dict(plan, smem_bytes=1024),
                dict(plan, warps=32), dict(plan, smem_bytes=300 * 1024),
                dict(plan, warps=12, smem_bytes=64 * 1024),
                dict(plan, chunk_tiles=4)):
        with pytest.raises(RuntimeError):
            K.attention(q, k, v, num_heads=2, scale=1.0, plan=bad)
    with pytest.raises(ValueError):
        K.attention(q, k, v, num_heads=2, scale=1.0,
                    key_valid=torch.zeros(2, 100, device=dev))


@pytest.mark.parametrize("n,bias", [(100, True), (356, False)])
def test_flash_mha_train_dropout_is_repeatable_and_differentiable(dev, n,
                                                                  bias):
    """Rate 0.1: one seed gives bit-equal outputs across two calls, and the
    output and gradients (the backward regenerates the forward's mask)
    match the plain version fed dropout_mask(seed)."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, h, d, rate = 2, 8, 32, 0.1
    g = torch.Generator().manual_seed(3)
    q, k, v, go = (torch.randn(b, n, h, d, generator=g).to(dev)
                   for _ in range(4))
    valid = (torch.rand(b, n, generator=g) > 0.2).to(dev)
    valid[:, 0] = True
    bt = torch.randn(b, h, n, n, generator=g).to(dev) if bias else None

    def run(fn, **kw):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        bl = None if bt is None else bt.clone().requires_grad_(True)
        out = fn(*leaves, valid, bl, **kw)
        grads = torch.autograd.grad(
            out, leaves + ([bl] if bl is not None else []), go)
        return out.detach(), grads

    def gen():
        return torch.Generator(device=dev).manual_seed(11)

    out, grads = run(FA.flash_mha_train, dropout_rate=rate, generator=gen())
    again, _ = run(FA.flash_mha_train, dropout_rate=rate, generator=gen())
    assert torch.equal(out, again)
    keep = K.dropout_mask(FA.dropout_seed(gen(), dev), rate, b * h, n,
                          n).reshape(b, h, n, n)
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.01
    ref, rgrads = run(FA.flash_mha_train_plain, dropout_rate=rate, keep=keep)
    _close(out, ref)
    for a, r in zip(grads, rgrads):
        rel = ((a - r).norm() / r.norm()).item()
        assert rel <= 1e-3, rel


def _kernel_names(fn):
    """Names of the device kernels and copies one call of fn() starts
    (tools/bench_attention.py traced: one warm call first, traces taken
    again while one lacks a kernel's device event)."""
    from edgecape_tpu_torch.tools import bench_attention as BA
    return [name for name, _, _ in BA.traced(fn) or ()]


def test_attention_ops_are_one_launch_and_count_it(dev):
    """One call raises its launch counter by one and launches one kernel:
    the bool mask is read in the kernel, no torch.where pass."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 100, 8, 32, generator=g).to(dev)
               for _ in range(3))
    valid = (torch.rand(2, 100, generator=g) > 0.3).to(dev)
    valid[:, 0] = True
    n0 = FA.launches
    names = _kernel_names(lambda: FA.flash_mha(q, k, v, valid))
    assert FA.launches == n0 + 2          # the warm-up call and the traced
    assert len(names) == 1 and "attn_kernel" in names[0], names
    n0 = FA.launches_fwd
    with torch.no_grad():
        names = _kernel_names(lambda: FA.flash_mha_train(q, k, v, valid))
    assert FA.launches_fwd == n0 + 2
    assert len(names) == 1 and "train_fwd_kernel" in names[0], names


def test_sine_feats_match_pytorch(dev):
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops.fused_decoder import _rdt
    g = torch.Generator().manual_seed(9)
    ct = torch.rand(77, 2, generator=g).to(dev)
    rdt = _rdt(16, dev)
    feats = K.sine_feats(ct, rdt)
    ax = (ct[:, 0:1] * 6.283185307179586) * rdt
    ay = (ct[:, 1:2] * 6.283185307179586) * rdt
    ref = torch.cat([torch.sin(ay), torch.cos(ay), torch.sin(ax),
                     torch.cos(ax)], dim=-1)
    assert feats.shape == (77, 64) and feats.dtype == torch.bfloat16
    # one bf16 ulp of values up to 1
    assert (feats.float() - ref).abs().max().item() <= 2 ** -8


def _small_decoder(dev, layers, bias, seed=1, c=64, heads=2, ffn=96, nf=32):
    from edgecape_tpu_torch.models.transformer import Decoder
    dec = _randomize(Decoder(c, heads, ffn, layers, attn_bias=bias,
                             max_hops=4, num_feats=nf, use_flash=True), dev,
                     seed)
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
    # the model's width: the layer chain's kernels take C = 256
    width = dict(c=256, heads=8, ffn=384, nf=128)
    args = list(_small_decoder_inputs(dev, c=256))
    if not bias:
        args[5] = None
    kw = dict(num_heads=8, num_feats=128)
    with torch.no_grad():
        one = _small_decoder(dev, 1, bias, **width)
        n0 = FD.stack_launches
        o, p = FD.fused_decoder_stack(*args, one, **kw)
        assert FD.stack_launches == n0 + 1
        ro, rp = FD.fused_decoder_stack_plain(*args, one, **kw)
        for a, r in ((o, ro), (p, rp)):
            assert a.shape == (1, 3, 13, 2) and a.dtype == torch.float32
            d = (a - r).abs()
            assert bool(torch.isfinite(a).all())
            assert d.max().item() <= 2e-3 and d.mean().item() <= 2e-4
        two = _small_decoder(dev, 2, bias, seed=2, **width)
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
    """The prepared weights, the stack's own and each layer's, are rebuilt
    when a parameter is written (a load_state_dict) or replaced (a cast of
    the module)."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    width = dict(c=256, heads=8, ffn=384, nf=128)
    args = _small_decoder_inputs(dev, c=256)
    kw = dict(num_heads=8, num_feats=128)
    with torch.no_grad():
        dec = _small_decoder(dev, 1, True, **width)
        first, _ = FD.fused_decoder_stack(*args, dec, **kw)
        cached = dec._stack_cache[1]
        layer_cached = dec.layers[0]._kernel_weights[1]
        FD.fused_decoder_stack(*args, dec, **kw)
        assert dec._stack_cache[1] is cached          # reused
        assert dec.layers[0]._kernel_weights[1] is layer_cached
        other = _small_decoder(dev, 1, True, seed=5, **width)
        dec.load_state_dict(other.state_dict())
        second, _ = FD.fused_decoder_stack(*args, dec, **kw)
        want, _ = FD.fused_decoder_stack(*args, other, **kw)
        assert dec._stack_cache[1] is not cached
        assert dec.layers[0]._kernel_weights[1] is not layer_cached
        assert torch.equal(second, want) and not torch.equal(second, first)
        dec.to(torch.bfloat16)
        third, _ = FD.fused_decoder_stack(*args, dec, **kw)
        ref, _ = FD.fused_decoder_stack_plain(*args, dec, **kw)
        assert (third - ref).abs().max().item() <= 2e-3


# (b, g, n, c, f, reps): n 70 / 104 / 264 x C 128 / 256 / 384 x 0 / 1 / 6
# steps at b 4, g 2, F 192; then groups of 3 and 4, one F chunk (F 64) and
# two (F 128)
MM_CASES = [(4, 2, n, c, 192, reps) for n in (70, 104, 264)
            for c in (128, 256, 384) for reps in (0, 1, 6)] + [
    (6, 3, 70, 256, 192, 3), (4, 2, 264, 384, 128, 2),
    (8, 4, 13, 128, 64, 1), (4, 4, 104, 384, 64, 6)]


@pytest.mark.parametrize("b,g,n,c,f,reps", MM_CASES)
def test_mm_chain_matches_plain_and_fold_equals_loop(dev, b, g, n, c, f,
                                                     reps):
    """Ragged segments (n and g n not multiples of the 128-row tile) at the
    three widths, 0 to 6 steps, groups of 2 to 4 and hidden widths of one
    to three chunks: the kernel against the plain
    version within 2^-6 of the output's largest magnitude (bf16 roundings
    that flip and carry through the steps) and 0.5% of its mean magnitude
    on average, loop and fold bit-equal, no step the identity, one launch
    counted per call."""
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
    if reps == 0:
        assert torch.equal(fold, x)
        return
    ref = MC.mm_chain_plain(x, w1, w2, reps, g, True).float()
    d = (fold.float() - ref).abs()
    assert bool(torch.isfinite(fold.float()).all())
    assert d.max().item() <= 2 ** -6 * ref.abs().max().item()
    assert d.mean().item() <= 5e-3 * ref.abs().mean().item()
    assert not torch.equal(fold, x)


def test_mm_chain_refuses_what_it_does_not_take(dev):
    """Other widths, a hidden that is no multiple of 64 and an operand that
    does not start on 16 bytes raise before any launch; nothing is
    counted."""
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops import mm_chain as MC
    bf = torch.bfloat16
    x = _rn(dev, 2, 70, 256).to(bf)
    w1, w2 = _rn(dev, 256, 128).to(bf), _rn(dev, 128, 256).to(bf)
    n0 = MC.launches
    with pytest.raises(ValueError):
        MC.mm_chain(x[..., :64].contiguous(), w1[:64], w2[:, :64], 1, 1, True)
    with pytest.raises(ValueError):
        MC.mm_chain(x, w1[:, :96].contiguous(), w2[:96].contiguous(), 1, 1,
                    True)
    flat = torch.empty(2 * 70 * 256 + 1, dtype=bf, device=dev)
    with pytest.raises(ValueError):
        K.mm_chain(flat[1:].view(2 * 70, 256), w1, w2, 1, 2, 70)
    assert MC.launches == n0


def test_decoder_stack_launches(dev):
    """One call of the three-layer stack is 3 + 9 x 3 kernels: the k / v
    / kpos GEMMs, then per layer sine_feats, the two ref_point_head GEMMs,
    the qkv GEMM, the bias attention, dec_post_self, the cross-attention,
    dec_post_cross and the keypoint head; no GEMM on the thread-copy
    mainloop and no other attention form."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    dec = _small_decoder(dev, 3, True, c=256, heads=8, ffn=384, nf=128)
    args = [t.to(torch.bfloat16) if t.is_floating_point() and i != 1 else t
            for i, t in enumerate(_small_decoder_inputs(dev, c=256))]
    kw = dict(num_heads=8, num_feats=128)
    with torch.no_grad():
        n0 = dict(K.launches)
        names = _kernel_names(lambda: FD.fused_decoder_stack(*args, dec, **kw))
        assert K.launches["gemm_kernel"] == n0["gemm_kernel"]
        for k in ("bias_attn_kernel", "kpt_head_kernel"):
            assert K.launches[k] == n0[k] + 2 * 3
    assert len(names) == 3 + 9 * 3, names
    assert sum("bias_attn_kernel" in n for n in names) == 3
    assert sum("kpt_head_kernel" in n for n in names) == 3
    assert sum("dec_post_self_kernel" in n for n in names) == 3
    assert sum("dec_post_cross_kernel" in n for n in names) == 3
    assert not any("gemm_kernel<" in n for n in names)



# ------------------------------------------------------- ViT MLP kernel
# rows of vit_mlp_kernel: the eval chunk's query and support passes, the
# training step's (2 x 16 images), ragged tile counts, fewer than a tile
VIT_ROWS = [510 * 257, 34 * 257, 32 * 257, 300, 129, 1]


def _vit_mlp_weights(dev, kmajor, seed=40):
    """vit_mlp's weight dict (C 384, F 1536): bf16 matrices in torch
    Linear layout (kmajor) or as the JAX function takes them, fp32
    vectors; LayerScale 1 so that every step shows."""
    g = torch.Generator().manual_seed(seed)
    c, f = 384, 1536

    def rn(*shape, s=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * s + shift).to(dev)

    w1, w2 = rn(f, c, s=c ** -0.5), rn(c, f, s=f ** -0.5)   # [out, in]
    bf = torch.bfloat16
    w = {"g": rn(c, s=0.1, shift=1.0), "be": rn(c, s=0.1),
         "b1": rn(f, s=0.1), "b2": rn(c, s=0.1),
         "ls": torch.ones(c, device=dev), "kmajor": kmajor}
    if kmajor:
        w.update(w1=w1.to(bf).contiguous(), w2=w2.to(bf).contiguous())
    else:
        w.update(w1=w1.t().to(bf).contiguous(), w2=w2.t().to(bf).contiguous())
    return w


def _vit_mlp_ref(x, w, eps):
    from edgecape_tpu_torch.ops import plain
    w1, w2 = (w["w1"], w["w2"]) if w["kmajor"] else (w["w1"].t(), w["w2"].t())
    xf = x.float()
    h = plain.layer_norm(xf, w["g"], w["be"], eps)
    f = plain.gelu(plain.linear(h, w1, w["b1"]))
    return xf + w["ls"] * plain.linear(f, w2, w["b2"])


@pytest.mark.parametrize("rows", VIT_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kmajor", [True, False])
def test_vit_mlp_matches_plain(dev, rows, dtype, kmajor):
    """vit_mlp against the plain formulas (tests/test_torch_vit_mlp.py
    holds its order of operations against the TPU kernel's), x fp32 or
    bf16, weights in either layout, one counted launch."""
    from edgecape_tpu_torch.ops import kernels as K
    w = _vit_mlp_weights(dev, kmajor)
    x = _rn(dev, rows, 384, seed=41).to(dtype)
    n0 = K.launches["vit_mlp_kernel"]
    y, hn = K.vit_mlp(x, w, eps=1e-6, out_dtype=dtype)
    assert K.launches["vit_mlp_kernel"] == n0 + 1 and hn is None
    assert y.dtype == dtype and y.shape == (rows, 384)
    _close(y, _vit_mlp_ref(x, w, 1e-6).to(dtype))


@pytest.mark.parametrize("rows", [510 * 257, 300, 1])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_vit_mlp_next_ln_bit_equal_to_layernorm_kernel(dev, rows, x_dtype):
    """The next block's LN1 written in vit_mlp's epilogue equals
    layernorm_kernel on the same bf16 rows bit for bit; y stored as bf16
    is the intermediate the pair hands on."""
    from edgecape_tpu_torch.ops import kernels as K
    w = _vit_mlp_weights(dev, True, seed=42)
    x = _rn(dev, rows, 384, seed=43).to(x_dtype)
    g, be = _rn(dev, 384, seed=44) * 0.1 + 1.0, _rn(dev, 384, seed=45) * 0.1
    y, hn = K.vit_mlp(x, w, eps=1e-6, out_dtype=torch.bfloat16,
                      next_ln=(g, be))
    _, want = K.layernorm(y, g, be, 1e-6, out_f32=False, out_bf16=True)
    assert hn.dtype == torch.bfloat16 and torch.equal(hn, want)
    y32, _ = K.vit_mlp(x, w, eps=1e-6, out_dtype=torch.float32)
    assert torch.equal(y32.to(torch.bfloat16), y)


@pytest.mark.parametrize("rows", [16 * 257, 510 * 257])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_vit_mlp_rows_do_not_depend_on_the_call(dev, rows, x_dtype):
    """A row gets the same bits in one call on 2 x rows as in a call on
    its half: the second half's rows sit at another place in the 128-row
    tiles and on other blocks of the persistent grid in the one call
    (rows: the training step's 16 images of 257 tokens, the query pass's
    510), so the fc2 sum over the hidden chunks must run in one order for
    every block."""
    from edgecape_tpu_torch.ops import kernels as K
    w = _vit_mlp_weights(dev, True, seed=46)
    x = _rn(dev, 2 * rows, 384, seed=47).to(x_dtype)
    for out_dtype in (torch.float32, torch.bfloat16):
        whole, _ = K.vit_mlp(x, w, eps=1e-6, out_dtype=out_dtype)
        halves = torch.cat([K.vit_mlp(x[:rows], w, eps=1e-6,
                                      out_dtype=out_dtype)[0],
                            K.vit_mlp(x[rows:], w, eps=1e-6,
                                      out_dtype=out_dtype)[0]])
        assert torch.equal(whole, halves), \
            int((whole != halves).sum())


def test_vit_mlp_refuses_what_it_does_not_take(dev):
    from edgecape_tpu_torch.ops import kernels as K
    w = _vit_mlp_weights(dev, True)
    before = dict(K.launches)
    with pytest.raises(ValueError):          # 256 channels
        K.vit_mlp(_rn(dev, 10, 256), w, eps=1e-6, out_dtype=torch.float32)
    with pytest.raises(ValueError):          # weights in the other layout
        K.vit_mlp(_rn(dev, 10, 384), dict(w, kmajor=False), eps=1e-6,
                  out_dtype=torch.float32)
    with pytest.raises(ValueError):          # not contiguous
        K.vit_mlp(_rn(dev, 384, 20).t(), w, eps=1e-6,
                  out_dtype=torch.float32)
    assert K.launches == before


def test_vit_ops_launches(dev):
    """Kernels a call puts on the device: #9 one vit_mlp_kernel; #1 three
    (vit_qkv_kernel, vit_attn_kernel, vit_mlp_kernel); #2 six (the same
    for each block); #10 two (vit_qkv_kernel, vit_attn_kernel, its
    weights laid out once). No GEMM."""
    from edgecape_tpu_torch.ops import fused_attn_block as FB
    from edgecape_tpu_torch.ops import fused_mlp as FM
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    from edgecape_tpu_torch.ops import kernels as K
    Block, DinoV2Config, _, _ = _modules()
    bf = torch.bfloat16
    with torch.no_grad():
        a = _randomize(Block(DinoV2Config()), dev, 1)
        b = _randomize(Block(DinoV2Config()), dev, 2)
        x = _rn(dev, 4, 257, 384).to(bf)
        attn, mlp = _half_args(dev, 384, 1536)
        FM.fused_ln_mlp(x, *mlp)
        FB.fused_attn_block(x, *attn, num_heads=6)
        FV.fused_vit_block2(x, a, b, num_heads=6)   # weights cached
        cases = [(lambda: FM.fused_ln_mlp(x, *mlp), 1, 0, 1),
                 (lambda: FV.fused_vit_block(x, a, num_heads=6), 3, 1, 1),
                 (lambda: FV.fused_vit_block2(x, a, b, num_heads=6), 6, 2, 2),
                 (lambda: FB.fused_attn_block(x, *attn, num_heads=6), 2, 1,
                  0)]
        for fn, kernels, halves, mlps in cases:
            n0 = dict(K.launches)
            fn()
            moved = {k: n - n0[k] for k, n in K.launches.items()
                     if n != n0[k]}
            assert moved == {k: n for k, n in (
                ("vit_qkv_kernel", halves), ("vit_attn_kernel", halves),
                ("vit_mlp_kernel", mlps)) if n}, moved
            names = _kernel_names(fn)
            assert len(names) == kernels, names
            assert sum("vit_mlp_kernel" in n for n in names) == mlps, names
            for k in ("vit_qkv_kernel", "vit_attn_kernel"):
                assert sum(k in n for n in names) == halves, names


# ------------------------------------------------- ViT attention kernels
# (images, tokens) of vit_qkv_kernel / vit_attn_kernel: the eval chunk's
# query and support passes, the training step's frozen backbone (2 x 16
# images), the CUDA tests' 37 tokens, and ragged token counts around the
# 136-key box and the 128-row item
VIT_ATTN_SHAPES = [(510, 257), (34, 257), (32, 257), (3, 37), (1, 136),
                   (2, 137), (5, 129), (1, 272)]


def _vit_attn_weights(dev, seed=50):
    """The kernels' weight dict: bf16 matrices in torch Linear layout at
    1 / sqrt(fan-in), fp32 vectors, LayerScale 1."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, s=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g) * s + shift).to(dev)

    c = 384
    return {"n1w": rn(c, s=0.1, shift=1.0), "n1b": rn(c, s=0.1),
            "wqkv": rn(3 * c, c, s=c ** -0.5).to(torch.bfloat16),
            "bqkv": rn(3 * c, s=0.1),
            "wp": rn(c, c, s=c ** -0.5).to(torch.bfloat16), "bp": rn(c, s=0.1),
            "ls1": torch.ones(c, device=dev)}


@pytest.mark.parametrize("b,n", VIT_ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_qkv_and_vit_attn_match_plain(dev, b, n, dtype):
    """Each kernel against its plain version (tests/test_torch_vit_attn.py
    holds their order of operations against the TPU kernel's): vit_qkv on
    x fp32 or bf16, vit_attn on vit_qkv's output with fp32 output (#1's
    x1) and x.dtype (#10's), one counted launch each."""
    from edgecape_tpu_torch.ops import fused_attn_block as FA
    from edgecape_tpu_torch.ops import kernels as K
    w = _vit_attn_weights(dev)
    x = _rn(dev, b, n, 384, seed=51).to(dtype)
    a0 = dict(K.launches)
    qkv = K.vit_qkv(x.view(b * n, 384), w, eps=1e-6)
    assert qkv.dtype == torch.bfloat16 and qkv.shape == (b * n, 1152)
    _close(qkv, FA.vit_qkv_plain(x.view(b * n, 384), w, eps=1e-6))
    qkv = qkv.view(b, n, 1152)
    for odt in (torch.float32, dtype):
        y = K.vit_attn(qkv, x, w, out_dtype=odt)
        assert y.dtype == odt and y.shape == x.shape
        _close(y, FA.vit_attn_plain(qkv, x, w, num_heads=6, out_dtype=odt))
    assert K.launches["vit_qkv_kernel"] == a0["vit_qkv_kernel"] + 1
    assert K.launches["vit_attn_kernel"] == a0["vit_attn_kernel"] + 2


def test_vit_attn_kernels_refuse_what_they_do_not_take(dev):
    from edgecape_tpu_torch.ops import kernels as K
    w = _vit_attn_weights(dev)
    bf = torch.bfloat16
    before = dict(K.launches)
    with pytest.raises(ValueError):          # 256 channels
        K.vit_qkv(_rn(dev, 10, 256), w, eps=1e-6)
    with pytest.raises(ValueError):          # not contiguous
        K.vit_qkv(_rn(dev, 384, 20).t(), w, eps=1e-6)
    with pytest.raises(ValueError):          # fp32 qkv, on the streaming
        K.vit_attn(_rn(dev, 1, 273, 1152), _rn(dev, 1, 273, 384), w,
                   out_dtype=torch.float32)     # route (273 tokens)
    with pytest.raises(ValueError):          # qkv of another width
        K.vit_attn(_rn(dev, 2, 37, 768).to(bf), _rn(dev, 2, 37, 256), w,
                   out_dtype=torch.float32)
    with pytest.raises(ValueError):          # x of another shape
        K.vit_attn(_rn(dev, 2, 37, 1152).to(bf), _rn(dev, 2, 36, 384), w,
                   out_dtype=torch.float32)
    with pytest.raises(ValueError):          # a CPU residual
        K.vit_attn(_rn(dev, 2, 37, 1152).to(bf), torch.zeros(2, 37, 384), w,
                   out_dtype=torch.float32)
    assert K.launches == before


def test_fused_attn_block_refuses_other_widths(dev):
    """The kernels take C 384 in 6 heads and, on the wide route, every C of
    64..1024 in steps of 64 in heads of up to 128; a wider trunk (1088
    channels) raises on the card (the CPU takes the plain version)."""
    from edgecape_tpu_torch.ops import fused_attn_block as FB
    attn, _ = _half_args(dev, 1088, 64)
    n0 = FB.launches
    with pytest.raises(ValueError):
        FB.fused_attn_block(_rn(dev, 3, 37, 1088), *attn, num_heads=17)
    assert FB.launches == n0


# ------------------------------------------- the streaming kernels (long rows)
# name, batch, Nq, Nk, heads, head dim, key mask, bias: the 518 px shapes
# (ViT 1370 tokens, joint encoder 1469, decoder cross-attention 100 x
# 1369), just past the caps and a ragged count.
LONG_SHAPES = [("vit 518", 2, 1370, 1370, 6, 64, False, False),
               ("encoder 518", 2, 1469, 1469, 8, 32, True, False),
               ("cross 518", 2, 100, 1369, 8, 64, False, False),
               ("past 512", 2, 513, 513, 8, 32, True, True),
               ("ragged 1025", 1, 1025, 1025, 4, 64, True, False),
               # head dim 128 past the resident kernels' 416 keys: the
               # 512 / 8 head's cross-attention at 518 px, just past the
               # cap with a mask and a bias, head dim 96 run padded
               ("cross 518 d128", 2, 100, 1369, 8, 128, False, False),
               ("past 416 d128", 2, 417, 417, 4, 128, True, True),
               ("ragged 1025 d96", 1, 1025, 1025, 2, 96, True, False)]


def _long_counter(name, d):
    """The launch counter of a streaming kernel's instance at head dim d
    (the head-dim-128 instances, padded ones included, counted apart)."""
    return f"{name}<128>" if d > 64 else name


@pytest.mark.parametrize("shape", LONG_SHAPES, ids=lambda s: s[0])
def test_long_attention_matches_plain(dev, shape):
    """attn_long_kernel against the plain version, one launch a call."""
    from edgecape_tpu_torch.ops import kernels as K
    _, b, nq, nk, h, d, mask, bias = shape
    q, k, v, valid, bt = _attn_operands(dev, b, nq, nk, h, d, torch.bfloat16,
                                        mask, bias)
    before = dict(K.launches)
    out = K.attention(q, k, v, num_heads=h, scale=d ** -0.5, key_valid=valid,
                      bias=bt)
    name = _long_counter("attn_long_kernel", d)
    assert K.launches[name] == before[name] + 1
    assert K.launches["attn_kernel"] == before["attn_kernel"]
    _close(out, _plain_attention(q, k, v, valid, bt, h, d))


@pytest.mark.parametrize("nk,d,mask,bias", [(356, 32, True, False),
                                            (257, 64, False, False),
                                            (100, 32, True, True),
                                            (7, 64, True, False),
                                            (300, 128, True, True),
                                            (129, 128, False, False)])
def test_long_attention_is_the_two_pass_form_bit_for_bit(dev, nk, d, mask,
                                                         bias):
    """The streaming training kernels forced at a shape the resident
    kernels take. (Named for the two-pass form they had before their
    one-pass redesign, whose bits were the resident kernels'; one pass
    rounds p elsewhere, so this holds three other things.) The forward
    and the gradients match autograd through the plain version to the
    kernels' bound; two calls give the same bits; a row's output,
    statistics and dq, and a key's dk and dv, keep their bits in either
    half of the batch, and a query's output, statistics and dq with the
    first queries cut off."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    h, nq = 4, nk
    q, k, v, valid, bt = _attn_operands(dev, 2, nq, nk, h, d, torch.bfloat16,
                                        mask, bias, seed=nk)
    g = _rn(dev, 2, nq, h * d, seed=3)

    def run(sel=slice(None), qsel=slice(None)):
        qs, ks, vs, gs = q[sel][:, qsel], k[sel], v[sel], g[sel][:, qsel]
        n = qs.shape[1]
        kv = None if valid is None else valid[sel]
        bs = None if bt is None else bt[sel][:, :, qsel]
        kw = dict(num_heads=h, scale=d ** -0.5, key_valid=kv, bias=bs)
        o, st = K.attention_train_fwd(
            qs, ks, vs, plan=K.attention_plan(n, nk, d, train=True,
                                              long=True), **kw)
        grads = K.attention_train_bwd(
            qs, ks, vs, gs, st, out=o,
            plan=K.attention_bwd_plan(n, nk, d, long=True), **kw)
        b = qs.shape[0]
        return [o, st.reshape(b, h, n, 2)] + [x for x in grads
                                              if x is not None]

    before = dict(K.launches)
    whole = run()
    for kern in ("train_fwd_long_kernel", "train_bwd_q_long_kernel",
                 "train_bwd_k_long_kernel"):
        name = _long_counter(kern, d)
        assert K.launches[name] == before[name] + 1
    # against the plain version
    heads = [t.reshape(2, -1, h, d) for t in (q, k, v, g)]
    ref, rgrads = _grads(FA.flash_mha_train_plain, *heads, valid,
                         None if bt is None else bt.float())
    _close(whole[0], ref.reshape(whole[0].shape))
    for a, r in zip(whole[2:], rgrads):
        _close(a.reshape(r.shape), r)
    # two calls, the same bits
    assert all(torch.equal(a, b) for a, b in zip(run(), whole))
    # each half of the batch alone: the same rows (dk, dv: the same keys)
    for half in (slice(0, 1), slice(1, 2)):
        for a, b in zip(run(half), whole):
            assert torch.equal(a, b[half])
    # the first queries cut off: the same output, statistics and dq rows
    if nq > 5:
        cut = run(qsel=slice(5, None))
        assert torch.equal(cut[0], whole[0][:, 5:])
        assert torch.equal(cut[1], whole[1][:, :, 5:])
        assert torch.equal(cut[2], whole[2][:, 5:])


@pytest.mark.parametrize("nk,d,mask,bias", [(356, 32, True, False),
                                            (257, 64, False, False),
                                            (100, 32, True, True),
                                            (7, 64, True, False),
                                            (256, 128, False, False),
                                            (100, 128, True, True)])
def test_long_attention_forced_matches_plain(dev, nk, d, mask, bias):
    """attn_long_kernel forced at a shape the resident kernels take, and
    attn_kernel there, both against the plain version at the smoke's
    bound."""
    from edgecape_tpu_torch.ops import kernels as K
    h, nq = 4, nk
    q, k, v, valid, bt = _attn_operands(dev, 2, nq, nk, h, d, torch.bfloat16,
                                        mask, bias, seed=nk)
    ref = _plain_attention(q, k, v, valid, bt, h, d)
    for kw in ({}, {"long": True}):
        _close(K.attention(q, k, v, num_heads=h, scale=d ** -0.5,
                           key_valid=valid, bias=bt,
                           plan=K.attention_plan(nq, nk, d, **kw)), ref)


@pytest.mark.parametrize("shape", LONG_SHAPES[:3], ids=lambda s: s[0])
def test_long_attention_rows_are_independent(dev, shape):
    """attn_long_kernel's rows depend on their own query, the keys and the
    mask alone: a batch of 16 gives the bits of its two 8-image halves and
    of a permuted batch, and cutting the first 37 queries off changes no
    other row."""
    from edgecape_tpu_torch.ops import kernels as K
    _, _, nq, nk, h, d, mask, bias = shape
    b = 16
    q, k, v, valid, _ = _attn_operands(dev, b, nq, nk, h, d, torch.bfloat16,
                                       mask, False, seed=nq)

    def att(sel=slice(None), qsel=slice(None)):
        return K.attention(q[sel][:, qsel], k[sel], v[sel], num_heads=h,
                           scale=d ** -0.5,
                           key_valid=None if valid is None else valid[sel])

    whole = att()
    assert torch.equal(torch.cat([att(slice(0, 8)), att(slice(8, 16))]),
                       whole)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(1))
    assert torch.equal(att(perm.to(dev)), whole[perm.to(dev)])
    assert torch.equal(att(qsel=slice(37, None)), whole[:, 37:])


@pytest.mark.parametrize("n,h,d,masked,with_bias", [
    (1469, 8, 32, True, False), (600, 4, 32, True, True),
    (513, 2, 64, False, True), (1025, 2, 64, True, False),
    (1469, 4, 128, True, False), (600, 2, 96, True, True),
    (400, 2, 128, False, True)])
def test_long_train_matches_plain(dev, n, h, d, masked, with_bias):
    """train_fwd_long_kernel and the streaming backward pair against
    autograd through the plain version at rate 0; both long kernels ran
    (their head-dim-128 instances above head dim 64)."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    q, k, v, g, valid, bias = _train_case(dev, 1, n, h, d, masked, with_bias)
    before = dict(K.launches)
    out, grads = _grads(FA.flash_mha_train, q, k, v, g, valid, bias)
    ran = {name: K.launches[name] - before[name] for name in K.launches}
    # at head dim 128 up to 416 keys the forward stays resident, while the
    # backward streams from about 400 rows
    fwd = (_long_counter("train_fwd_long_kernel", d)
           if K.attention_plan(n, n, d, train=True).get("long")
           else "train_fwd_kernel")
    assert ran[fwd] == 1 and ran["train_fwd_kernel"] == (fwd ==
                                                         "train_fwd_kernel")
    assert ran[_long_counter("train_bwd_q_long_kernel", d)] \
        == ran[_long_counter("train_bwd_k_long_kernel", d)] == 1
    assert ran["train_bwd_q_kernel"] == 0
    ref, rgrads = _grads(FA.flash_mha_train_plain, q, k, v, g, valid, bias)
    _close(out, ref)
    for a, r in zip(grads, rgrads):
        d_ = (a - r).abs()
        assert bool(torch.isfinite(a).all())
        assert d_.max().item() <= 5e-3 + 2 ** -6 * r.abs().max().item()


@pytest.mark.parametrize("nq,nk", [(600, 600), (1, 600), (600, 1)])
def test_long_train_masked_rows_and_edge_counts(dev, nq, nk):
    """The streaming training kernels forced (600 tokens stream anyway),
    rate 0.1, with a bias: a batch whose keys are all masked gives a zero
    output and zero, finite gradients; the other batch matches the plain
    version fed dropout_mask(seed), down to one query or one key."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, h, d, rate = 2, 2, 32, 0.1
    q = _rn(dev, b, nq, h * d, seed=1)
    k, v = _rn(dev, b, nk, h * d, seed=2), _rn(dev, b, nk, h * d, seed=3)
    g = _rn(dev, b, nq, h * d, seed=4)
    bias = _rn(dev, b, h, nq, nk, seed=5)
    valid = torch.ones(b, nk, dtype=torch.bool, device=dev)
    valid[1] = False
    seed = FA.dropout_seed(torch.Generator(device=dev).manual_seed(5), dev)
    kw = dict(num_heads=h, scale=d ** -0.5, key_valid=valid, bias=bias,
              seed=seed, rate=rate)
    o, st = K.attention_train_fwd(
        q, k, v, plan=K.attention_plan(nq, nk, d, train=True, long=True),
        **kw)
    grads = K.attention_train_bwd(
        q, k, v, g, st, out=o, plan=K.attention_bwd_plan(nq, nk, d,
                                                         long=True), **kw)
    assert bool((o[1] == 0).all())
    for t in grads:
        assert bool(torch.isfinite(t).all()) and bool((t[1] == 0).all())
    keep = K.dropout_mask(seed, rate, b * h, nq, nk).reshape(b, h, nq, nk)
    heads = [t.reshape(b, -1, h, d) for t in (q, k, v, g)]
    ref, rgrads = _grads(FA.flash_mha_train_plain, *heads, valid, bias,
                         dropout_rate=rate, keep=keep)
    _close(o[0], ref[0].reshape(o[0].shape))
    for a, r in zip(grads, rgrads):
        _close(a[0].reshape(r[0].shape), r[0])


@pytest.mark.parametrize("nq,nk", [(1469, 1469), (100, 600), (1, 600)])
def test_long_train_at_head_dim_128_with_dropout(dev, nq, nk):
    """The head-dim-128 streaming training kernels at rate 0.1 with a key
    mask and a bias: output and gradients against autograd through the
    plain version fed dropout_mask(seed), and two calls bit for bit."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, h, d, rate = 1, 2, 128, 0.1
    q = _rn(dev, b, nq, h * d, seed=11)
    k, v = _rn(dev, b, nk, h * d, seed=12), _rn(dev, b, nk, h * d, seed=13)
    g = _rn(dev, b, nq, h * d, seed=14)
    bias = _rn(dev, b, h, nq, nk, seed=15)
    valid = _rn(dev, b, nk, seed=16) > -0.3
    valid[:, 0] = True
    seed = FA.dropout_seed(torch.Generator(device=dev).manual_seed(7), dev)
    kw = dict(num_heads=h, scale=d ** -0.5, key_valid=valid, bias=bias,
              seed=seed, rate=rate)

    def run():
        o, st = K.attention_train_fwd(q, k, v, **kw)
        return [o, st] + list(K.attention_train_bwd(q, k, v, g, st, out=o,
                                                    **kw))

    before = dict(K.launches)
    whole = run()
    for kern in ("train_fwd_long_kernel", "train_bwd_q_long_kernel",
                 "train_bwd_k_long_kernel"):
        assert K.launches[kern + "<128>"] == before[kern + "<128>"] + 1
    keep = K.dropout_mask(seed, rate, b * h, nq, nk).reshape(b, h, nq, nk)
    heads = [t.reshape(b, -1, h, d) for t in (q, k, v, g)]
    ref, rgrads = _grads(FA.flash_mha_train_plain, *heads, valid, bias,
                         dropout_rate=rate, keep=keep)
    _close(whole[0], ref.reshape(whole[0].shape))
    for a, r in zip(whole[2:], rgrads):
        _close(a.reshape(r.shape), r)
    assert all(torch.equal(a, c) for a, c in zip(run(), whole))


def test_long_train_dropout_mask_is_the_mask_of_its_seed(dev):
    """At rate 0.1 the streaming forward drops what dropout_mask(seed)
    keeps out: the plain version fed that mask gives the same output."""
    from edgecape_tpu_torch.ops import flash_attention as FA
    from edgecape_tpu_torch.ops import kernels as K
    b, n, h, d = 1, 700, 2, 32
    q, k, v, _, valid, _ = _train_case(dev, b, n, h, d, True, False)
    gen = torch.Generator(device=dev).manual_seed(5)
    seed = FA.dropout_seed(gen, dev)
    out, _ = K.attention_train_fwd(
        *(t.reshape(b, n, h * d) for t in (q, k, v)), num_heads=h,
        scale=d ** -0.5, key_valid=valid, seed=seed, rate=0.1)
    keep = K.dropout_mask(seed, 0.1, b * h, n, n).reshape(b, h, n, n)
    ref = FA.flash_mha_train_plain(q, k, v, valid, dropout_rate=0.1,
                                   keep=keep)
    _close(out, ref.reshape(out.shape))


@pytest.mark.parametrize("n", [273, 325, 1370])
def test_long_vit_half_matches_plain(dev, n):
    """fused_vit_block above 272 tokens: vit_qkv_kernel, attn_long_kernel,
    the GEMM with the LayerScale residual and vit_mlp_kernel, against the
    plain block; vit_attn_kernel does not run."""
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    from edgecape_tpu_torch.ops import kernels as K
    Block, DinoV2Config, _, _ = _modules()
    with torch.no_grad():
        blk = _randomize(Block(DinoV2Config()), dev)
    x = _rn(dev, 2, n, 384, seed=n).to(torch.bfloat16)
    before = dict(K.launches)
    with torch.no_grad():
        out = FV.fused_vit_block(x, blk, num_heads=6)
        ref = FV.fused_vit_block_plain(x, blk, num_heads=6)
    ran = {name: K.launches[name] - before[name] for name in K.launches
           if K.launches[name] != before[name]}
    assert ran == {"vit_qkv_kernel": 1, "attn_long_kernel": 1,
                   "gemm_tma_kernel": 1, "vit_mlp_kernel": 1}, ran
    _close(out, ref)


def test_main_path_plans_do_not_stream(dev):
    """The 224 px path's shapes keep the resident kernels."""
    from edgecape_tpu_torch.ops import kernels as K
    for nq, nk, d in ((257, 257, 64), (356, 356, 32), (100, 100, 32),
                      (100, 256, 64)):
        assert "long" not in K.attention_plan(nq, nk, d)
        assert "long" not in K.attention_plan(nq, nk, d, train=True)
    assert "long" not in K.attention_bwd_plan(356, 356, 32)
    for b in (510, 34, 32):
        assert "long" not in K.vit_attn_plan(b, 257, 384, 6)


# ------------------------------------------ the wide ViT route (vit_wide.cu)
# (rows, C, N) of vit_ln_gemm_kernel: ViT-B/14's qkv and fc1, ViT-L/14's,
# widths whose last 256-column group is partly or half past N (448 x 1344,
# 1024 x 1088: N = 64 (4 g + 1); 576 x 192), the narrowest, each with a
# ragged last 128-row tile; odd counts of tiles (300 rows, 8738); fewer
# rows than a tile (5, 37, 77, 65) and than the grid's warps' quads; the
# support pass's 34 x 257 rows, whose plan splits the groups
LN_GEMM_SHAPES = [(300, 768, 2304), (129, 768, 3072), (77, 1024, 3072),
                  (65, 1024, 4096), (130, 448, 1344), (5, 64, 64),
                  (200, 576, 192), (37, 768, 2304), (200, 1024, 1088),
                  (8738, 768, 2304)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["qkv", "fc1"])
@pytest.mark.parametrize("b_nk", [True, False])
@pytest.mark.parametrize("shape", LN_GEMM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_vit_ln_gemm_matches_plain(dev, shape, b_nk, form, x_dtype):
    """qkv: x (fp32 or bf16) rounded to bf16 before LN1, no activation;
    fc1: x as it is, GELU; W as torch Linear weights or in the JAX
    layout."""
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    from edgecape_tpu_torch.ops import kernels as K
    r, c, n = shape
    x = _rn(dev, r, c, seed=c).to(x_dtype)
    g, be = 1 + _rn(dev, c, s=0.1, seed=1), _rn(dev, c, s=0.1, seed=2)
    w = _rn(dev, n, c, s=c ** -0.5, seed=3).to(torch.bfloat16)
    if not b_nk:
        w = w.t().contiguous()
    bias = _rn(dev, n, s=0.1, seed=4)
    kw = dict(eps=1e-6, b_nk=b_nk, gelu=form == "fc1",
              round_in=form == "qkv")
    n0 = K.launches["vit_ln_gemm_kernel"]
    out = K.vit_ln_gemm(x, g, be, w, bias, **kw)
    assert K.launches["vit_ln_gemm_kernel"] == n0 + 1
    assert out.dtype == torch.bfloat16 and out.shape == (r, n)
    _close(out, FV.vit_ln_gemm_plain(x, g, be, w, bias, **kw))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_vit_ln_gemm_rows_do_not_depend_on_the_call(dev, x_dtype):
    """A row's bits are the same in a call on the support pass's 8738
    rows (69 tiles; the plan splits each tile's groups into parts) as in
    calls on its pieces: two halves cut at row 437 (other tiles, another
    share of the LayerNorm pass), the first 2000 rows (another column
    split), and in calls on all rows at every column split 1..9 (each
    part's columns from another CTA): each element sums its k slabs in
    one order."""
    from edgecape_tpu_torch.ops import kernels as K
    x = _rn(dev, 8738, 768, seed=5).to(x_dtype)
    g, be = 1 + _rn(dev, 768, s=0.1, seed=6), _rn(dev, 768, s=0.1, seed=7)
    w = _rn(dev, 2304, 768, s=768 ** -0.5, seed=8).to(torch.bfloat16)
    bias = _rn(dev, 2304, s=0.1, seed=9)

    def call(rows, **kw):
        return K.vit_ln_gemm(rows.contiguous(), g, be, w, bias, eps=1e-6,
                             round_in=True, **kw)
    whole = call(x)
    split = K.vit_ln_gemm_card_plan(8738, 768, 2304)["column_split"]
    assert split > 1
    assert K.vit_ln_gemm_card_plan(2000, 768, 2304)["column_split"] != split
    assert torch.equal(whole[:1000],
                       torch.cat([call(x[:437]), call(x[437:1000])]))
    assert torch.equal(whole[128:1128], call(x[128:1128]))
    assert torch.equal(whole[:2000], call(x[:2000]))
    for parts in range(1, 10):
        assert torch.equal(whole, call(x, column_split=parts)), parts
    with pytest.raises(ValueError, match="column split"):
        call(x, column_split=10)


def test_vit_ln_gemm_refuses_what_it_does_not_take(dev):
    from edgecape_tpu_torch.ops import kernels as K
    before = dict(K.launches)
    for c, n in ((1088, 2304), (100, 256), (768, 100)):
        with pytest.raises(ValueError):
            K.vit_ln_gemm(_rn(dev, 10, c), torch.ones(c, device=dev),
                          torch.zeros(c, device=dev),
                          torch.zeros(n, c, device=dev, dtype=torch.bfloat16),
                          torch.zeros(n, device=dev), eps=1e-6)
    with pytest.raises(ValueError):          # not contiguous
        K.vit_ln_gemm(_rn(dev, 768, 20).t(), torch.ones(768, device=dev),
                      torch.zeros(768, device=dev),
                      torch.zeros(64, 768, device=dev, dtype=torch.bfloat16),
                      torch.zeros(64, device=dev), eps=1e-6)
    assert K.launches == before


@pytest.mark.parametrize("c,h,n", [(768, 12, 37), (1024, 16, 37),
                                   (768, 12, 600), (448, 7, 50)],
                         ids=["vit-b", "vit-l", "vit-b-long", "448-7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_block_matches_plain(dev, c, h, n, dtype):
    """fused_vit_block on the wide route against the plain block: two
    vit_ln_gemm_kernel launches, the attention (streamed above 512
    tokens), two GEMMs, none of the resident ViT kernels; fused_vit_block2
    bit-equal to two calls."""
    from edgecape_tpu_torch.ops import fused_vit_block as FV
    from edgecape_tpu_torch.ops import kernels as K
    Block, DinoV2Config, _, _ = _modules()
    cfg = DinoV2Config(embed_dim=c, num_heads=h)
    with torch.no_grad():
        a, b = _randomize(Block(cfg), dev, 1), _randomize(Block(cfg), dev, 2)
    x = _rn(dev, 3, n, c, seed=n).to(dtype)
    before = dict(K.launches)
    with torch.no_grad():
        out = FV.fused_vit_block(x, a, num_heads=h)
        ran = {k: K.launches[k] - before[k] for k in K.launches
               if K.launches[k] != before[k]}
        _close(out, FV.fused_vit_block_plain(x, a, num_heads=h))
        pair = FV.fused_vit_block2(x, a, b, num_heads=h)
        two = FV.fused_vit_block(FV.fused_vit_block(x, a, num_heads=h), b,
                                 num_heads=h)
    attn = "attn_long_kernel" if n > K.ATT_MAX_KEYS else "attn_kernel"
    assert ran == {"vit_ln_gemm_kernel": 2, attn: 1, "gemm_tma_kernel": 2}, \
        ran
    assert out.dtype == dtype and torch.equal(pair, two)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_halves_match_plain(dev, dtype):
    """fused_ln_mlp (weights in the JAX layout) and fused_attn_block at
    ViT-B/14's width, 111 rows, each against its plain version."""
    from edgecape_tpu_torch.ops import fused_attn_block as FB
    from edgecape_tpu_torch.ops import fused_mlp as FM
    from edgecape_tpu_torch.ops import kernels as K
    attn, mlp = _half_args(dev, 768, 3072)
    x = _rn(dev, 3, 37, 768).to(dtype)
    n0 = K.launches["vit_ln_gemm_kernel"]
    out = FM.fused_ln_mlp(x, *mlp)
    assert out.dtype == dtype
    _close(out, FM.fused_ln_mlp_plain(x, *mlp))
    out = FB.fused_attn_block(x, *attn, num_heads=12)
    assert out.dtype == dtype
    _close(out, FB.fused_attn_block_plain(x, *attn, num_heads=12))
    assert K.launches["vit_ln_gemm_kernel"] == n0 + 2


# ---------------------------------------- head_wide.cu: the two redesigns
# (C, heads, FFN) of chip_smoke.py WIDTHS; enc_post_wide_kernel runs where
# C is not 256, bias_attn_wide_kernel where the heads are not 8 of 32
HEAD_WIDTHS = [(128, 8, 256), (200, 8, 300), (256, 4, 512), (384, 8, 768),
               (512, 16, 1024), (512, 8, 1024)]
WIDE_ENC = [w for w in HEAD_WIDTHS if w[0] != 256] + [(100, 4, 96)]


def _wide_encoder(dev, c, h, f, seed):
    """An EncoderLayer of width c (random weights) and its prepared,
    padded kernel weights (ops/fused_encoder.py _prepare)."""
    from edgecape_tpu_torch.models.transformer import EncoderLayer
    from edgecape_tpu_torch.ops import fused_encoder as FE
    layer = _randomize(EncoderLayer(c, h, f), dev, seed)
    return layer, FE._prepare(layer)


def _enc_post_ref(att, src, layer):
    """The plain formulas of the encoder's post-attention half on the
    layer's own (unpadded) weights."""
    from edgecape_tpu_torch.ops import plain
    op, n1 = layer.self_attn.out_proj, layer.norm1
    x = plain.layer_norm(src.float() + plain.linear(att, op.weight, op.bias),
                         n1.weight, n1.bias, 1e-5)
    h = torch.relu(plain.linear(x, layer.linear1.weight, layer.linear1.bias))
    return plain.layer_norm(
        x + plain.linear(h, layer.linear2.weight, layer.linear2.bias),
        layer.norm2.weight, layer.norm2.bias, 1e-5)


@pytest.mark.parametrize("c,h,f", WIDE_ENC, ids=lambda v: str(v))
@pytest.mark.parametrize("rows", [60 * 356, 300, 129, 1])
def test_enc_post_wide_matches_plain(dev, c, h, f, rows):
    """enc_post_wide_kernel against the plain formulas at the widths of
    [widths] (and 100 channels: an unaligned row), over ragged 64-row
    tiles: y in fp32 and bf16, the next layer's src = bf16(bf16(y) + pos);
    one launch of it and none of enc_post_kernel."""
    from edgecape_tpu_torch.ops import kernels as K
    layer, w = _wide_encoder(dev, c, h, f, seed=c + f)
    att = _rn(dev, rows, c, seed=41).to(torch.bfloat16)
    src = _rn(dev, rows, c, seed=42).to(torch.bfloat16)
    pos = _rn(dev, 356, c, seed=43).to(torch.bfloat16)
    with torch.no_grad():
        ref = _enc_post_ref(att, src, layer)
        for out_dtype in (torch.float32, torch.bfloat16):
            before = dict(K.launches)
            y, nxt = K.enc_post(att, src, w, eps=1e-5, out_dtype=out_dtype,
                                pos=pos)
            ran = {k: K.launches[k] - before[k] for k in K.launches
                   if K.launches[k] != before[k]}
            assert ran == {"enc_post_wide_kernel": 1}, ran
            assert y.dtype == out_dtype and y.shape == (rows, c)
            _close(y, ref)
            want = (y.to(torch.bfloat16).float()
                    + pos.float().repeat(-(-rows // 356), 1)[:rows]).to(
                torch.bfloat16)
            assert torch.equal(nxt, want)


@pytest.mark.parametrize("c,h,f", [(200, 8, 300), (512, 8, 1024)])
def test_enc_post_wide_rows_keep_their_bits_at_another_place(dev, c, h, f):
    """A row's output does not depend on its place in the batch or on the
    row count: the rows reversed, and a slice of them alone, give each row
    the same bits."""
    from edgecape_tpu_torch.ops import kernels as K
    _, w = _wide_encoder(dev, c, h, f, seed=7)
    att = _rn(dev, 700, c, seed=44).to(torch.bfloat16)
    src = _rn(dev, 700, c, seed=45).to(torch.bfloat16)
    with torch.no_grad():
        y, _ = K.enc_post(att, src, w, eps=1e-5, out_dtype=torch.float32)
        rev = torch.arange(699, -1, -1, device=dev)
        y_rev, _ = K.enc_post(att[rev].contiguous(), src[rev].contiguous(), w,
                              eps=1e-5, out_dtype=torch.float32)
        part, _ = K.enc_post(att[37:137].contiguous(),
                             src[37:137].contiguous(), w, eps=1e-5,
                             out_dtype=torch.float32)
    assert torch.equal(y_rev[rev], y)
    assert torch.equal(part, y[37:137])


def _wide_bias_operands(dev, b, n, heads, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    c, nhop, hid = heads * d, 5, 4 + heads
    qkv = torch.randn(b, n, 3 * c, generator=g).to(dev).to(torch.bfloat16)
    hops = torch.rand(b, n, n, nhop, generator=g).to(dev).to(torch.bfloat16)
    mlp = (torch.randn(nhop, hid, generator=g).to(dev),
           (torch.randn(hid, generator=g) * 0.1).to(dev),
           (torch.randn(hid, heads, generator=g) / math.sqrt(hid)).to(dev),
           (torch.randn(heads, generator=g) * 0.1).to(dev))
    valid = (torch.rand(b, n, generator=g) > 0.3).to(dev)
    valid[:, 0] = True
    return qkv, valid, hops, mlp


# the [widths] self-attention heads (8 of 16, 25, 48, 64; 4 of 64; 16 of
# 32) and head dim 128 (4 heads; 16: several passes of one head)
WIDE_HEADS = [(8, 16), (8, 25), (4, 64), (8, 48), (16, 32), (8, 64),
              (4, 128), (16, 128)]


@pytest.mark.parametrize("heads,d", WIDE_HEADS, ids=lambda v: str(v))
@pytest.mark.parametrize("b,n", [(60, 100), (3, 37), (2, 128), (5, 7)])
def test_bias_attention_wide_matches_plain(dev, heads, d, b, n):
    """bias_attn_wide_kernel against the plain version at K = 100 (the
    model's), 37, 128 and 7, every padding of the head dim, resident heads
    and passes of heads: within the tolerance and an ulp of an output
    (the MLP summed in another order); one launch of it and none of
    bias_attn_kernel."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    qkv, valid, hops, mlp = _wide_bias_operands(dev, b, n, heads, d,
                                                seed=heads + d + n)
    before = dict(K.launches)
    out = K.bias_attention(qkv, valid, hops, mlp, num_heads=heads)
    ran = {k: K.launches[k] - before[k] for k in K.launches
           if K.launches[k] != before[k]}
    assert ran == {"bias_attn_wide_kernel": 1}, ran
    ref = FD.bias_attention_plain(qkv, valid, hops, mlp, num_heads=heads)
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, heads * d)
    _close(out, ref)
    d_ = (out.float() - ref).abs()
    assert d_.max().item() <= 2 ** -7 and d_.mean().item() <= 1e-4


@pytest.mark.parametrize("heads,d", [(8, 25), (8, 64), (16, 32)])
def test_bias_attention_wide_rows_keep_their_bits_at_another_place(dev, heads,
                                                                   d):
    """A batch row's output does not depend on its place in the batch or
    on the batch size: the batch reversed, and one row alone, give the
    same bits."""
    from edgecape_tpu_torch.ops import kernels as K
    qkv, valid, hops, mlp = _wide_bias_operands(dev, 60, 100, heads, d, 3)
    out = K.bias_attention(qkv, valid, hops, mlp, num_heads=heads)
    rev = torch.arange(59, -1, -1, device=dev)
    out_rev = K.bias_attention(qkv[rev].contiguous(), valid[rev].contiguous(),
                               hops[rev].contiguous(), mlp, num_heads=heads)
    one = K.bias_attention(qkv[17:18].contiguous(), valid[17:18].contiguous(),
                           hops[17:18].contiguous(), mlp, num_heads=heads)
    assert torch.equal(out_rev[rev], out)
    assert torch.equal(one[0], out[17])


# -------- dec_self_wide.cu, dec_wide.cu: the decoder's post-attention kernels
def _wide_decoder(dev, c, h, f, seed):
    """A DecoderLayer of width c (random weights) and its prepared kernel
    weights (ops/fused_decoder.py _prepare)."""
    from edgecape_tpu_torch.models.transformer import DecoderLayer
    from edgecape_tpu_torch.ops import fused_decoder as FD
    layer = _randomize(DecoderLayer(c, h, f), dev, seed)
    return layer, FD._prepare(layer)


def _ran(before):
    from edgecape_tpu_torch.ops import kernels as K
    return {k: K.launches[k] - before[k] for k in K.launches
            if K.launches[k] != before[k]}


# batch rows and K: the [widths] chunk's 60 x 100, and K 1, 63 and 128
DEC_ROWS = [(60, 100), (133, 1), (3, 63), (2, 128)]
# the six [widths] widths, a width of no multiple of 8 (element loads of
# the attention outputs) and an odd one (the scalar residual and stores)
DEC_WIDTHS = HEAD_WIDTHS + [(100, 4, 96), (511, 7, 300)]


@pytest.mark.parametrize("c", [1, 100, 200, 384, 511])
def test_dec_wide_plan_rings_are_the_kernels(dev, c):
    """ops/kernels.py dec_wide_rings, which post_plan reports, equals the
    ring slots and shared memory that csrc/dec_wide.cu's launches take."""
    from edgecape_tpu_torch.ops import kernels as K
    assert K.dec_wide_card_rings(c) == K.dec_wide_rings(c)


@pytest.mark.parametrize("c,h,f", DEC_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("b,k", DEC_ROWS)
def test_dec_post_self_wide_matches_plain(dev, c, h, f, b, k):
    """dec_post_self at the six [widths] widths, 100 and 511 channels
    (dec_post_self_wide_kernel but at 256 channels) against the plain
    formulas on the unpadded weights, over ragged 64-row tiles; one
    launch."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    layer, w = _wide_decoder(dev, c, h, f, seed=c + f)
    r = b * k
    att, xb, qpos = (_rn(dev, r, c, seed=60 + i).to(torch.bfloat16)
                     for i in range(3))
    with torch.no_grad():
        before = dict(K.launches)
        x1, q2 = K.dec_post_self(att, xb, qpos, w, eps=1e-5)
        name = "dec_post_self_kernel" if c == 256 else \
            "dec_post_self_wide_kernel"
        assert _ran(before) == {name: 1}
        ref = FD.post_self_plain(att, xb, layer)
        qref = FD.cross_query_plain(x1, qpos, layer)
    assert x1.dtype == torch.float32 and x1.shape == (r, c)
    assert q2.dtype == torch.bfloat16 and q2.shape == (r, 2 * c)
    _close(x1, ref)
    _close(q2, qref)


@pytest.mark.parametrize("c,h,f", DEC_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("b,k", DEC_ROWS)
@pytest.mark.parametrize("adj_dtype", [torch.float32, torch.bfloat16])
def test_dec_post_cross_wide_matches_plain(dev, c, h, f, b, k, adj_dtype):
    """dec_post_cross at the six widths, 100 and 511 channels: away from
    256 channels its two launches, dec_post_cross_wide_kernel and
    dec_post_gcn_wide_kernel (one or two 64-row tiles a batch row),
    against the plain formulas on the unpadded weights, fp32 and bf16
    adjacency."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    layer, w = _wide_decoder(dev, c, h, f, seed=c + f + 1)
    att2 = _rn(dev, b, k, 2 * c, seed=70).to(torch.bfloat16)
    x1 = _rn(dev, b * k, c, seed=71)
    adj = (_rn(dev, b, 2, k, k, seed=72).abs() / k).to(adj_dtype)
    with torch.no_grad():
        before = dict(K.launches)
        out = K.dec_post_cross(att2, x1, adj, w, eps=1e-5,
                               out_dtype=torch.float32)
        want = {"dec_post_cross_kernel": 1} if c == 256 else {
            "dec_post_cross_wide_kernel": 1, "dec_post_gcn_wide_kernel": 1}
        assert _ran(before) == want
        ref = FD.post_cross_plain(att2, x1.view(b, k, c), adj, layer)
    assert out.dtype == torch.float32 and out.shape == (b * k, c)
    _close(out.view(b, k, c), ref)


@pytest.mark.parametrize("c,h,f", [(200, 8, 300), (512, 8, 1024)])
def test_dec_post_wide_rows_keep_their_bits_at_another_place(dev, c, h, f):
    """A batch row's outputs do not depend on its place in the batch: the
    batch reversed, and one batch row alone, give its rows the same bits
    (x1 and q2 of the self kernel, the cross layer's output)."""
    from edgecape_tpu_torch.ops import kernels as K
    _, w = _wide_decoder(dev, c, h, f, seed=9)
    b, k = 60, 100
    att, xb, qpos = (_rn(dev, b, k, c, seed=80 + i).to(torch.bfloat16)
                     for i in range(3))
    att2 = _rn(dev, b, k, 2 * c, seed=83).to(torch.bfloat16)
    adj = _rn(dev, b, 2, k, k, seed=84).abs() / k
    rev = torch.arange(b - 1, -1, -1, device=dev)

    def run(sel):
        x1, q2 = K.dec_post_self(*(t[sel].reshape(-1, c).contiguous()
                                   for t in (att, xb, qpos)), w, eps=1e-5)
        out = K.dec_post_cross(att2[sel].contiguous(), x1,
                               adj[sel].contiguous(), w, eps=1e-5,
                               out_dtype=torch.float32)
        n = x1.shape[0] // k
        return x1.view(n, k, c), q2.view(n, k, 2 * c), out.view(n, k, c)
    with torch.no_grad():
        whole = run(torch.arange(b, device=dev))
        flipped = run(rev)
        one = run(torch.arange(17, 18, device=dev))
    for a, r_, o in zip(whole, flipped, one):
        assert torch.equal(r_[rev], a)
        assert torch.equal(o[0], a[17])


def test_dec_post_wide_refuse_cpu_operands_and_count_nothing(dev):
    """The wide decoder ops take CUDA operands only: a CPU operand raises
    before any launch, and nothing is counted."""
    from edgecape_tpu_torch.ops import kernels as K
    _, w = _wide_decoder(dev, 200, 8, 300, seed=11)
    att = _rn(dev, 100, 200).to(torch.bfloat16)
    before = dict(K.launches)
    with pytest.raises(ValueError):
        K.dec_post_self(att.cpu(), att, att, w, eps=1e-5)
    with pytest.raises(ValueError):
        K.dec_post_cross(_rn(dev, 1, 100, 400).to(torch.bfloat16),
                         _rn(dev, 100, 200), _rn(dev, 1, 2, 100, 100).cpu(),
                         w, eps=1e-5, out_dtype=torch.float32)
    assert K.launches == before


# --------------------------------- kpt_wide.cu: kpt_head_wide_kernel
# The keypoint head at the [widths] widths but 256 (the 512-channel ones
# once), a width of no multiple of 8 (element loads of x) and an odd one;
# row counts: the [widths] and eval chunks' 60 and 510 query rows of K 100,
# a partial tile, one row. The coordinates are held against kpt_head_plain
# with its products summed in float64 (KPT_MAX, KPT_MEAN of chip_smoke.py:
# coordinates in [0, 1] through delta heads of 0.02, where a flipped bf16
# rounding of a hidden value moves one by about 1e-5) and, on the mean,
# against the fp32 plain version. Where the fp32 plain version is itself
# farther than KPT_MAX from the float64-summed one (its own sums' rounding
# reaches 1.8e-4 at 512 channels and 51000 rows in chip_smoke.py's lines,
# PERF.md), the max of 102000 coordinates sits at the arithmetic's noise
# floor: there the kernel's mean error may be no larger than the fp32
# plain version's, and its max no more than KPT_MAX beyond the plain
# version's own.
KPT_WIDE_C = [128, 200, 384, 512, 100, 511]
KPT_MAX, KPT_MEAN = 2e-4, 1e-5


def _kpt_operands(dev, c, r, seed):
    """x, ct (first row clipped at both ends), the final norm, the three
    kpt_branch layers unpadded and padded to the plan's c_pad (pad_cols),
    the delta head."""
    from edgecape_tpu_torch.ops import kernels as K
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)
    cp = K.kpt_head_plan(r, c).get("c_pad", c)      # no padding: split
    kpt0 = [(rn(c, c, s=c ** -0.5).to(torch.bfloat16), rn(c, s=0.1))
            for _ in range(3)]
    kpt = [(K.pad_cols(w, cp, cp).contiguous(), b) for w, b in kpt0]
    fn = (1.0 + rn(c, s=0.1), rn(c, s=0.1))
    kow, kob = rn(2, c, s=0.02).to(torch.bfloat16), rn(2, s=0.02)
    x = rn(r, c).to(torch.bfloat16)
    ct = torch.rand(r, 2, generator=g).to(dev)
    ct[0] = torch.tensor([0.0, 1.0])
    return x, ct, fn, kpt0, kpt, kow, kob


@pytest.mark.parametrize("c", [1, 64, 100, 128, 192, 200, 255, 257, 384,
                               385, 511, 512])
def test_kpt_wide_plan_layout_is_the_kernels(dev, c):
    """ops/kernels.py kpt_wide_layout, which kpt_head_plan reports, equals
    the padded width, ring slots and shared memory that csrc/kpt_wide.cu's
    launch takes."""
    from edgecape_tpu_torch.ops import kernels as K
    lay = K.kpt_wide_layout(c)
    assert K.kpt_wide_card_layout(c) == lay
    plan = K.kpt_head_plan(6000, c)
    assert (plan["c_pad"], plan["slots"], plan["smem_bytes"]) == (
        lay["c_pad"], lay["slots"], lay["smem_bytes"])


@pytest.mark.parametrize("c", KPT_WIDE_C)
@pytest.mark.parametrize("rows", [6000, 51000, 129, 1])
def test_kpt_head_wide_matches_plain(dev, c, rows):
    """kpt_head at every width but 256 is one launch of
    kpt_head_wide_kernel, within KPT_MAX and KPT_MEAN of the float64-summed
    plain version on the unpadded weights (where the fp32 plain version
    misses KPT_MAX itself: as accurate as it on the mean, within KPT_MAX
    of its max) and within KPT_MEAN of the fp32 one, finite."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    x, ct, fn, kpt0, kpt, kow, kob = _kpt_operands(dev, c, rows, c + rows)
    pts, outs = torch.empty_like(ct), torch.empty_like(ct)
    with torch.no_grad():
        before = dict(K.launches)
        K.kpt_head(x, ct, fn, kpt, kow, kob, pts, outs, eps=1e-5)
        assert _ran(before) == {"kpt_head_wide_kernel": 1}
        got = torch.stack([pts, outs])
        ref = torch.stack(FD.kpt_head_plain(x, ct, fn, kpt0, kow, kob,
                                            eps=1e-5, sums=torch.float64))
        ref32 = torch.stack(FD.kpt_head_plain(x, ct, fn, kpt0, kow, kob,
                                              eps=1e-5))
    assert bool(torch.isfinite(got).all())
    d, own = (got - ref).abs(), (ref32 - ref).abs()
    err = (d.max().item(), d.mean().item(), own.max().item(),
           own.mean().item())
    if own.max().item() <= KPT_MAX:
        assert d.max().item() <= KPT_MAX, err
    else:
        assert d.mean().item() <= own.mean().item(), err
        assert d.max().item() <= own.max().item() + KPT_MAX, err
    assert d.mean().item() <= KPT_MEAN, err
    assert (got - ref32).abs().mean().item() <= KPT_MEAN


@pytest.mark.parametrize("c", [100, 200, 512])
def test_kpt_head_wide_rows_keep_their_bits_at_another_place(dev, c):
    """A row's coordinates do not depend on its place in the batch: the
    rows reversed, and one row alone, give it the same bits."""
    from edgecape_tpu_torch.ops import kernels as K
    r = 6000
    x, ct, fn, _, kpt, kow, kob = _kpt_operands(dev, c, r, 3)
    rev = torch.arange(r - 1, -1, -1, device=dev)

    def run(sel):
        xs, cs = x[sel].contiguous(), ct[sel].contiguous()
        pts, outs = torch.empty_like(cs), torch.empty_like(cs)
        K.kpt_head(xs, cs, fn, kpt, kow, kob, pts, outs, eps=1e-5)
        return pts, outs
    with torch.no_grad():
        whole = run(torch.arange(r, device=dev))
        flipped = run(rev)
        one = run(torch.arange(4321, 4322, device=dev))
    for a, f, o in zip(whole, flipped, one):
        assert torch.equal(f[rev], a)
        assert torch.equal(o[0], a[4321])


def test_kpt_head_wide_refuses_cpu_operands_and_counts_nothing(dev):
    """A CPU operand or unpadded weights raise before any launch, and
    nothing is counted."""
    from edgecape_tpu_torch.ops import kernels as K
    x, ct, fn, kpt0, kpt, kow, kob = _kpt_operands(dev, 200, 300, 5)
    pts, outs = torch.empty_like(ct), torch.empty_like(ct)
    before = dict(K.launches)
    with pytest.raises(ValueError):
        K.kpt_head(x.cpu(), ct, fn, kpt, kow, kob, pts, outs, eps=1e-5)
    with pytest.raises(ValueError):
        K.kpt_head(x, ct, fn, kpt0, kow, kob, pts, outs, eps=1e-5)
    assert K.launches == before


# ------------------------------------------- the split route, C above 512
# the heads of ViT-B/14's and ViT-L/14's widths
SPLIT_WIDTHS = [(768, 12, 1536), (1024, 16, 2048)]


@pytest.mark.parametrize("c", [600, 640, 1024, 1536])
def test_layernorm_takes_any_width(dev, c):
    """layernorm_kernel past 512 channels (the passes looped over 64-column
    groups) against the plain LayerNorm: LN(x) and LN(x + r) with an fp32
    or a bf16 residual, the fp32 output written in place over x and the
    bf16 one into a column block of a wider buffer (its row stride); the
    bf16 output is the fp32 one rounded; one launch each."""
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops import plain
    x = _rn(dev, 333, c, s=3.0, seed=c) + 1.0
    g, be = _rn(dev, c, s=0.1, seed=c + 1) + 1.0, _rn(dev, c, s=0.1,
                                                      seed=c + 2)
    for r in (None, _rn(dev, 333, c, seed=c + 3),
              _rn(dev, 333, c, seed=c + 4).to(torch.bfloat16)):
        ref = plain.layer_norm(x if r is None else x + r.float(), g, be,
                               1e-5)
        buf = torch.zeros(333, 2 * c, dtype=torch.bfloat16, device=dev)
        xin = x.clone()
        n0 = K.launches["layernorm_kernel"]
        of, ob = K.layernorm(xin, g, be, 1e-5, r=r, out_f32=xin,
                             out_bf16=buf[:, c:])
        assert K.launches["layernorm_kernel"] == n0 + 1
        assert of.data_ptr() == xin.data_ptr()
        torch.testing.assert_close(of, ref, atol=1e-5, rtol=1e-5)
        assert torch.equal(buf[:, c:], of.to(torch.bfloat16))
        assert not buf[:, :c].any()


@pytest.mark.parametrize("c", [577, 768, 1024])
def test_kpt_coord_matches_plain(dev, c):
    """kpt_coord_kernel (the split route's delta head and coordinate
    update) against kpt_coord_plain on 6000 rows (the [widths] chunk's),
    coordinates clipped at both ends among them, an odd C (element loads)
    too: to fp32 noise; one launch."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import kernels as K
    r = 6000
    h = _rn(dev, 2 * r, c, seed=c).to(torch.bfloat16)
    wo = _rn(dev, 2, c, s=0.02, seed=c + 1).to(torch.bfloat16)
    bo = _rn(dev, 2, s=0.02, seed=c + 2)
    ct = torch.rand(r, 2, generator=torch.Generator().manual_seed(c)).to(dev)
    ct[0], ct[1] = torch.tensor([0.0, 1.0]), torch.tensor([-0.1, 1.1])
    pts, outs = torch.empty_like(ct), torch.empty_like(ct)
    n0 = K.launches["kpt_coord_kernel"]
    K.kpt_coord(h, ct, wo, bo, pts, outs)
    assert K.launches["kpt_coord_kernel"] == n0 + 1
    for got, want in zip((pts, outs), FD.kpt_coord_plain(h, ct, wo, bo)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _split_modules(dev, c, h, f, seed):
    from edgecape_tpu_torch.models.transformer import (DecoderLayer,
                                                       EncoderLayer)
    return (_randomize(EncoderLayer(c, h, f), dev, seed),
            _randomize(DecoderLayer(c, h, f, attn_bias=True), dev, seed + 1))


def _counted(fn):
    """fn's result and the kernels it launched (the non-zero counts)."""
    from edgecape_tpu_torch.ops import kernels as K
    before = dict(K.launches)
    out = fn()
    return out, {k: v - before[k] for k, v in K.launches.items()
                 if v != before[k]}


@pytest.mark.parametrize("c,h,f", SPLIT_WIDTHS)
@pytest.mark.parametrize("k", [100, 133])
def test_split_post_ops_match_plain(dev, c, h, f, k):
    """The split route's ops at 768 and 1024 channels on the [widths]
    chunk's 60 query rows of K 100 or 133 keypoints, against the plain
    formulas on the same inputs: enc_post (with the next layer's src),
    dec_post_self, dec_post_cross (fp32 and bf16 out), kpt_head; each
    call's launches as its plan names them, none on the thread-copy
    GEMM."""
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import fused_encoder as FE
    from edgecape_tpu_torch.ops import kernels as K
    from edgecape_tpu_torch.ops import plain
    bf, b = torch.bfloat16, 60
    r = b * k
    enc, dec = _split_modules(dev, c, h, f, seed=c + k)
    we, wd = FE._prepare(enc), FD._prepare(dec)
    att, src = (_rn(dev, r, c, seed=s).to(bf) for s in (1, 2))
    pos = _rn(dev, k, c, seed=3).to(bf)
    with torch.no_grad():
        (y, nxt), n = _counted(lambda: K.enc_post(
            att, src, we, eps=1e-5, out_dtype=torch.float32, pos=pos))
        assert n == {"gemm_tma_kernel": 3, "layernorm_kernel": 2,
                     "add_pos_kernel": 1}
        op, n1 = enc.self_attn.out_proj, enc.norm1
        x = plain.layer_norm(src.float() + plain.linear(att, op.weight,
                                                        op.bias),
                             n1.weight, n1.bias, 1e-5)
        hid = torch.relu(plain.linear(x, enc.linear1.weight,
                                      enc.linear1.bias))
        _close(y, plain.layer_norm(
            x + plain.linear(hid, enc.linear2.weight, enc.linear2.bias),
            enc.norm2.weight, enc.norm2.bias, 1e-5))
        assert torch.equal(nxt, (y.to(bf).float()
                                 + pos.float().repeat(b, 1)).to(bf))

        qpos = _rn(dev, r, c, seed=4).to(bf)
        (x1, q2), n = _counted(lambda: K.dec_post_self(att, src, qpos, wd,
                                                       eps=1e-5))
        assert n == {"gemm_tma_kernel": 2, "layernorm_kernel": 1}
        x1r = FD.post_self_plain(att.float(), src, dec)
        _close(x1, x1r)
        _close(q2, plain.bf16(FD.cross_query_plain(x1, qpos, dec)))

        att2 = _rn(dev, b, k, 2 * c, seed=5).to(bf)
        adj = torch.rand(b, 2, k, k, generator=torch.Generator()
                         .manual_seed(6)).to(dev) / k
        want = FD.post_cross_plain(att2.float(), x1r.view(b, k, c), adj, dec)
        for dt in (torch.float32, bf):
            out, n = _counted(lambda: K.dec_post_cross(
                att2, x1r, adj, wd, eps=1e-5, out_dtype=dt))
            assert n == {"gemm_tma_kernel": 6, "layernorm_kernel": 2}
            assert out.dtype == dt
            _close(out.view(b, k, c), want)

    xk, ct, fn, kpt, _, kow, kob = _kpt_operands(dev, c, r, k)
    pts, outs = torch.empty_like(ct), torch.empty_like(ct)
    _, n = _counted(lambda: K.kpt_head(xk, ct, fn, kpt, kow, kob, pts, outs,
                                       eps=1e-5))
    assert n == {"layernorm_kernel": 1, "gemm_tma_kernel": 3,
                 "kpt_coord_kernel": 1}
    rp, ro = FD.kpt_head_plain(xk, ct, fn, kpt, kow, kob, eps=1e-5)
    _close(pts, rp)
    _close(outs, ro)


@pytest.mark.parametrize("c,h,f", SPLIT_WIDTHS)
def test_split_layers_and_stacks_run_their_launches(dev, c, h, f):
    """At 768 and 1024 channels: the encoder stack of three layers in
    1 + 8 x 3 - 1 kernels, bit-equal to its chain of layers; a decoder
    layer (K 100) in 17 and a decoder stack (K 133, with the Markov bias)
    in 3 + 22 x 3, each against its plain version (a stack layer by
    layer, to chip_smoke.py's STACK_LAYER_MAX / STACK_LAYER_MEAN, which
    assume delta heads of 0.02); no GEMM on the thread-copy mainloop."""
    from edgecape_tpu_torch.models.transformer import Decoder
    from edgecape_tpu_torch.ops import fused_decoder as FD
    from edgecape_tpu_torch.ops import fused_encoder as FE
    bf, nq, hw = torch.bfloat16, 4, 256
    encs = [_split_modules(dev, c, h, f, seed=s)[0] for s in (1, 3, 5)]
    _, dec = _split_modules(dev, c, h, f, seed=7)
    tok, pos = _rn(dev, nq, hw + 100, c, seed=8).to(bf), _rn(
        dev, hw + 100, c, seed=9).to(bf)
    valid = torch.ones(nq, hw + 100, dtype=torch.bool, device=dev)
    valid[:, -20:] = False
    with torch.no_grad():
        out, n = _counted(lambda: FE.fused_encoder_stack(
            tok, pos, valid, encs, num_heads=h))
        assert n == {"add_pos_kernel": 3, "gemm_tma_kernel": 12,
                     "attn_kernel": 3, "layernorm_kernel": 6}
        x = tok
        for layer in encs:
            x = FE.fused_encoder_layer(x, pos, valid, layer, num_heads=h)
        assert torch.equal(out, x)
        k = 100
        kx, qpos = (_rn(dev, nq, k, c, seed=s).to(bf) for s in (10, 11))
        img, ipos = _rn(dev, nq, hw, c, seed=12).to(bf), _rn(
            dev, hw, c, seed=13).to(bf)
        kvalid = torch.rand(nq, k, generator=torch.Generator().manual_seed(
            14)).to(dev) > 0.3
        kvalid[:, 0] = True
        bias = _rn(dev, nq, h, k, k, seed=15)
        adj = torch.rand(nq, 2, k, k, generator=torch.Generator()
                         .manual_seed(16)).to(dev) / k
        out, n = _counted(lambda: FD.fused_decoder_layer(
            kx, qpos, img, ipos, kvalid, bias, adj, dec, num_heads=h))
        assert n == {"gemm_tma_kernel": 12, "layernorm_kernel": 3,
                     "attn_kernel": 2}
        _close(out, FD.fused_decoder_layer_plain(
            kx, qpos, img, ipos, kvalid, bias, adj, dec, num_heads=h))

        k, nf, nhop = 133, c // 2, 5
        g = torch.Generator().manual_seed(17)
        sdec = _randomize(Decoder(c, h, f, 3, attn_bias=True,
                                  max_hops=nhop - 1, num_feats=nf), dev, 18)
        with torch.no_grad():   # the delta heads at 0.02, as the bounds say
            for i, br in enumerate(sdec.kpt_branches):
                br.out.weight.copy_(_rn(dev, 2, c, s=0.02, seed=22 + i))
        kvalid = torch.rand(nq, k, generator=g).to(dev) > 0.2
        kvalid[:, 0] = True
        args = (_rn(dev, nq, k, c, s=0.5, seed=19).to(bf),
                (torch.rand(nq, k, 2, generator=g) * 0.8 + 0.1).to(dev),
                _rn(dev, nq, hw, c, s=0.5, seed=20).to(bf),
                _rn(dev, hw, c, s=0.5, seed=21).to(bf), kvalid,
                torch.rand(nq, k, k, nhop, generator=g).to(dev).to(bf),
                (torch.rand(nq, 2, k, k, generator=g) / k).to(dev).to(bf))
        kw = dict(num_heads=h, num_feats=nf)
        _, n = _counted(lambda: FD.fused_decoder_stack(*args, sdec, **kw))
        assert n == {"gemm_tma_kernel": 3 + 14 * 3, "layernorm_kernel": 12,
                     "attn_kernel": 3, "bias_attn_long_kernel": 3,
                     "sine_feats_kernel": 3, "kpt_coord_kernel": 3}
        for i in range(3):
            sub = Decoder(c, h, f, 1, attn_bias=True, max_hops=nhop - 1,
                          num_feats=nf)
            sub.layers[0], sub.kpt_branches[0] = sdec.layers[i], \
                sdec.kpt_branches[i]
            sub.ref_point_head, sub.norm = sdec.ref_point_head, sdec.norm
            sub.to(dev).eval()
            o, p = FD.fused_decoder_stack(*args, sub, **kw)
            ro, rp = FD.fused_decoder_stack_plain(*args, sub, **kw)
            d = torch.cat([(o - ro).abs().flatten(),
                           (p - rp).abs().flatten()])
            assert d.max().item() <= 2e-3 and d.mean().item() <= 1e-4, \
                (i, d.max().item(), d.mean().item())


@pytest.mark.parametrize("k", [1024, 2048])
def test_gemm_slabs_sum_as_accurately_as_fp32(dev, k):
    """The TMA GEMM's slab form (mainloop 2, the split route's): each
    64-deep k tile summed in a fresh accumulator and added in fp32, so over
    a long K its error against float64 sums stays at fp32's (torch.matmul
    in fp32 on the same bf16 values) where one accumulator drifts; the same
    epilogue, one launch counted as gemm_tma_kernel."""
    from edgecape_tpu_torch.ops import kernels as K
    a = _rn(dev, 1000, k, seed=k).to(torch.bfloat16)
    w = _rn(dev, 512, k, s=k ** -0.5, seed=k + 1).to(torch.bfloat16)
    bias = _rn(dev, 512, seed=k + 2)
    ref = (a.double() @ w.double().t() + bias.double()).float()
    f32 = a.float() @ w.float().t() + bias
    n0 = K.launches["gemm_tma_kernel"]
    slab = K.gemm(a, w, b_nk=True, bias=bias, out_dtype=torch.float32,
                  slabs=True)
    one = K.gemm(a, w, b_nk=True, bias=bias, out_dtype=torch.float32)
    assert K.launches["gemm_tma_kernel"] == n0 + 2
    err = {n: (t - ref).abs().mean().item()
           for n, t in (("slab", slab), ("one", one), ("fp32", f32))}
    assert err["slab"] <= 2 * err["fp32"], err
    assert err["slab"] < err["one"], err
    torch.testing.assert_close(slab, ref, atol=1e-4, rtol=1e-4)
