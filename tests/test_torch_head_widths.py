"""The head widths the hand-written kernels take (ops/kernels.py): every
attention head dim from 1 to 128 runs at the kernels' 32, 64 or 128 with
its q, k, v padded by zero columns (pad_heads); the post-attention
kernels, the keypoint head and the bias attention take every width up to
512 channels in 1..16 heads (the 256-channel kernels at 256, their
csrc/head_wide.cu companions elsewhere), the FFN and GCN hidden padded by
zero rows and columns (pad_ffn, pad_gcn, laid out once by the fused ops'
`_prepare`). What stays refused is named by the plan that refuses it.

The padding forms are held against the JAX package on unpadded operands:
plain attention on padded heads (eval and training, with gradients)
against the JAX Pallas kernels in interpret mode, at head dims 25 and 50,
with the bounds of tests/test_torch_attention_plan.py; the plain layers
on padded weights against the unpadded ones to fp32 noise. The kernels'
own order at these widths is emulated in tests/test_torch_fused_post.py,
the whole model at d_model 200 in tests/test_torch_width_routes.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import flash_attention as jflash
from edgecape_tpu_torch.config import ModelConfig
from edgecape_tpu_torch.models.transformer import DecoderLayer, EncoderLayer
from edgecape_tpu_torch.ops import flash_attention as tflash
from edgecape_tpu_torch.ops import fused_decoder as tdec
from edgecape_tpu_torch.ops import fused_encoder as tenc
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain

STAGE3 = dict(learn_skeleton=True, attn_bias=True, use_flash=True)
# (d_model, nhead, dim_feedforward) the card's [widths] phase runs
WIDTHS = [(128, 8, 256), (200, 8, 300), (256, 4, 512), (384, 8, 768),
          (512, 16, 1024), (512, 8, 1024)]


def _width_cfg(c, h, ffn, **kw):
    return ModelConfig(**STAGE3, d_model=c, nhead=h, dim_feedforward=ffn,
                       num_feats=c // 2, similarity_proj_dim=c, **kw)


# ------------------------------------------------------------- plans
def test_every_head_dim_runs_at_a_launched_instance():
    """Head dims 1..128 run at the first of 32, 64, 128 at or above them,
    in every eval and training plan the head's shapes give; the plan
    names the padded dim where it differs; every plan fits a block's
    shared memory."""
    for d in range(1, 129):
        dp = K.attention_head_dim(d)
        assert dp in K.ATT_HEAD_DIMS and dp >= d
        assert dp == 32 or dp // 2 < d
        plans = [K.attention_plan(100, 100, d), K.attention_plan(100, 256, d),
                 K.attention_plan(356, 356, d, train=True),
                 K.attention_bwd_plan(356, 356, d),
                 K.attention_bwd_plan(100, 100, d)]
        for plan in plans:
            assert plan.get("d_pad", d) == dp
            assert ("d_pad" in plan) == (d not in K.ATT_HEAD_DIMS)
            assert max(v for k, v in plan.items() if "smem" in k) \
                <= K.ATT_SMEM_LIMIT
        # the streaming kernels take the padded form at every head dim
        long = K.attention_plan(100, 1369, d)
        assert long["long"] and long.get("d_pad", d) == dp
        assert long["smem_bytes"] <= K.ATT_SMEM_LIMIT
    for d in (0, 129, 192, 256):
        with pytest.raises(ValueError, match="head dims 1..128"):
            K.attention_plan(100, 100, d)


def test_head_dim_128_holds_as_many_keys_as_a_block_does():
    """At head dim 128 the resident kernels take fewer warps a block where
    the keys and values leave no room (up to 416 keys); more keys take the
    streaming kernels (two ring stages forward, one item slot backward),
    and chunk_tiles, which picks the resident kernels, still refuses them."""
    assert K.attention_plan(100, 256, 128)["warps"] == 4
    assert K.attention_plan(100, 416, 128)["warps"] == 1
    assert "long" not in K.attention_plan(100, 416, 128)
    fwd = K.attention_plan(100, 417, 128)
    assert fwd["long"] and fwd["stages"] == 2 and fwd["key_tiles"] == 4
    assert fwd["smem_bytes"] == 199808 <= K.ATT_SMEM_LIMIT
    with pytest.raises(ValueError, match="does not fit"):
        K.attention_plan(100, 417, 128, chunk_tiles=K.ATT_CH16)
    bwd = K.attention_bwd_plan(356, 356, 128)
    assert bwd["q_warps"] < K.BWD_MAX_WARPS and bwd["k_warps"] < 4
    assert "long" not in bwd
    bwd = K.attention_bwd_plan(400, 400, 128)
    assert bwd["long"] and bwd["stages"] == 4
    assert bwd["q_smem_bytes"] == bwd["k_smem_bytes"] == 201856
    with pytest.raises(ValueError, match="does not fit"):
        K.attention_bwd_plan(400, 400, 128, chunk_tiles=K.ATT_CH16)


@pytest.mark.parametrize("c", [1, 16, 100, 128, 200, 255, 256, 257, 384,
                               511, 512])
def test_post_and_keypoint_plans_take_every_width(c):
    for f in (1, 64, 300, 384, 1024, 3000):
        for chunk, k in ((K.ENC_CHUNK, None), (K.DEC_CHUNK, 100)):
            plan = K.post_plan(100 * 7, c, f, chunk=chunk, keypoints=k)
            assert plan.get("wide", False) == (c != K.POST_C)
            fp = plan.get("f_pad", f)
            assert fp >= f and fp % (K.ENC_WIDE_CHUNK if c != K.POST_C
                                     else chunk) == 0
            if c != K.POST_C:
                assert plan["c_pad"] == 2 * plan["half"] >= c
                assert plan["c_pad"] % 128 == 0
                assert plan["c2_pad"] == 2 * plan["c_pad"]
                assert plan["smem_bytes"] <= K.ATT_SMEM_LIMIT
                assert plan["tiles"] == -(-700 // K.ENC_WIDE_TILE)
                assert sorted(plan["kernels"]) == (
                    ["dec_post_cross_wide_kernel", "dec_post_gcn_wide_kernel"]
                    if k else ["dec_post_self_wide_kernel",
                               "enc_post_wide_kernel"])
                if k:
                    assert plan["gcn_tiles"] == 7 * 2
    kp = K.kpt_head_plan(51000, c)
    assert kp.get("wide", False) == (c != K.POST_C)
    # past WIDE_MAX_C the split route (tests/test_torch_split_heads.py)
    # at channels in multiples of 8; 513 refused by name
    for big in (520, 1024):
        assert K.post_plan(10, big, 64)["split"]
        assert K.kpt_head_plan(10, big)["split"]
    for plan in (lambda: K.post_plan(10, 513, 64),
                 lambda: K.kpt_head_plan(10, 513)):
        with pytest.raises(ValueError, match="multiples of 8, got 513"):
            plan()
    with pytest.raises(ValueError, match="1 channel or more"):
        K.post_plan(10, 0, 64)
    with pytest.raises(ValueError, match="1 channel or more"):
        K.kpt_head_plan(10, 0)


@pytest.mark.parametrize("rows", [6000, 51000, 129, 1])
def test_kpt_head_plan_takes_every_width(rows):
    """kpt_head_plan from 1 to 512 channels: kpt_head_kernel's plan at
    POST_C, elsewhere kpt_head_wide_kernel's instance (rows up to 255
    channels, at c rounded up to 64; channels above 256, at twice
    enc_wide_half), c_pad a multiple of 64 holding c, tiles that cover the
    rows in source rows of 32 a warpgroup, rings of at least four WIDE_BOX
    slots in a block's shared memory (kpt_wide_layout's arithmetic); the
    refusals as before."""
    for c in range(1, K.WIDE_MAX_C + 1):
        plan = K.kpt_head_plan(rows, c)
        if c == K.POST_C:
            assert plan == {"tiles": -(-rows // 64)}
            continue
        lay = K.kpt_wide_layout(c)
        assert plan["wide"] and plan["c_pad"] == lay["c_pad"]
        assert plan["c_pad"] % 64 == 0 and plan["c_pad"] >= c
        if c < K.POST_C:
            assert plan["instance"] == "rows" and plan["rings"] == 1
            assert plan["c_pad"] - 64 < c and plan["half"] == plan["c_pad"]
            assert plan["source_rows"] == 64
        else:
            assert plan["instance"] == "channels" and plan["rings"] == 2
            assert plan["half"] == K.enc_wide_half(c)
            assert plan["c_pad"] == 2 * plan["half"]
            assert plan["source_rows"] == 32
        assert plan["tile_rows"] == 2 * plan["source_rows"]
        assert plan["tiles"] == -(-rows // plan["source_rows"])
        assert (plan["tiles"] - 1) * plan["source_rows"] < rows
        assert 4 <= plan["slots"] <= K.KPT_WIDE_SLOTS
        assert plan["slots"] == lay["slots"]
        assert plan["smem_bytes"] == lay["smem_bytes"] <= K.ATT_SMEM_LIMIT
        fixed = 1024 + (2 if lay["split"] else 4) * plan["c_pad"] // 64 \
            * K.WIDE_BOX + 1024 + 1024 + 7 * 4 * plan["c_pad"]
        ring = plan["rings"] * (K.WIDE_BOX + 16)
        assert plan["smem_bytes"] == fixed + plan["slots"] * ring
        assert plan["slots"] == K.KPT_WIDE_SLOTS or \
            plan["smem_bytes"] + ring > K.ATT_SMEM_LIMIT
    for big in (520, 1024):             # the split route
        assert K.kpt_head_plan(rows, big)["split"]
    with pytest.raises(ValueError, match="multiples of 8, got 513"):
        K.kpt_head_plan(rows, 513)
    with pytest.raises(ValueError, match="1 channel or more"):
        K.kpt_head_plan(rows, 0)
    with pytest.raises(ValueError, match="no rows"):
        K.kpt_head_plan(0, 200)


def _kpt_decoder(c):
    """A one-layer decoder of width c with seeded weights."""
    from edgecape_tpu_torch.models.transformer import Decoder
    torch.manual_seed(c)
    dec = Decoder(c, 1, 2 * c, 1, attn_bias=True, max_hops=4,
                  num_feats=max(c // 2, 1))
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return dec.eval()


@pytest.mark.parametrize("c", [2, 100, 200, 255, 256, 384, 511, 512])
def test_stack_weights_pad_the_kpt_branch_with_exact_zeros(c):
    """ops/fused_decoder.py _build_stack_weights lays each kpt_branch
    weight out at kpt_head_plan's c_pad: the layer's own weight (bf16) in
    the top left, exact zeros elsewhere; biases, the final norm and the
    delta head stay unpadded."""
    dec = _kpt_decoder(c)
    sw = tdec._build_stack_weights(dec, max(c // 2, 1), True)
    cp = K.kpt_head_plan(1, c).get("c_pad", c)
    br = dec.kpt_branches[0]
    lw = sw["layers"][0]
    for (w, b), fc in zip(lw["kpt"], (br.fc0, br.fc1, br.fc2)):
        assert w.shape == (cp, cp) and w.dtype == torch.bfloat16
        assert w.is_contiguous()
        assert torch.equal(w[:c, :c], fc.weight.detach().to(torch.bfloat16))
        assert not w[c:].any() and not w[:, c:].any()
        assert torch.equal(b, fc.bias.detach().float())
    assert lw["kow"].shape == (2, c) and lw["kob"].shape == (2,)
    assert all(v.shape == (c,) for v in sw["fn"])


@pytest.mark.parametrize("c", [100, 200, 384, 511])
@pytest.mark.parametrize("sums", [torch.float32, torch.float64])
def test_kpt_head_plain_over_padded_weights_is_unchanged(c, sums):
    """kpt_head_plain over the kpt_branch weights as the wide kernel takes
    them (padded with zeros to c_pad) gives the coordinates it gives over
    the layer's own weights, bit for bit: the zero columns of the hidden
    add +0 to every sum."""
    dec = _kpt_decoder(c)
    sw = tdec._build_stack_weights(dec, c // 2, True)
    lw = sw["layers"][0]
    br = dec.kpt_branches[0]
    kpt0 = [(fc.weight.detach(), fc.bias.detach())
            for fc in (br.fc0, br.fc1, br.fc2)]
    g = torch.Generator().manual_seed(c)
    x = plain.bf16(torch.randn(300, c, generator=g))
    ct = torch.rand(300, 2, generator=g)
    ct[0] = torch.tensor([0.0, 1.0])
    args = (lw["kow"], lw["kob"])
    padded = tdec.kpt_head_plain(x, ct, sw["fn"], lw["kpt"], *args, eps=1e-5,
                                 sums=sums)
    own = tdec.kpt_head_plain(x, ct, sw["fn"], kpt0, *args, eps=1e-5,
                              sums=sums)
    for a, b in zip(padded, own):
        assert a.shape == (300, 2) and a.dtype == torch.float32
        assert torch.equal(a, b)


def test_bias_plan_takes_1_to_16_heads_of_up_to_128():
    for heads in range(1, 17):
        for d in (1, 25, 32, 64, 128):
            plan = K.bias_attention_plan(60, 100, heads, d)
            assert plan.get("wide", False) == ((heads, d) != (8, 32))
            assert plan["smem_bytes"] <= K.ATT_SMEM_LIMIT
            if plan.get("wide"):
                assert plan["d_pad"] == K.attention_head_dim(d)
                assert plan["key_tiles"] == 7
                assert plan["q_split"] * plan["tiles_per_block"] >= 7
    for args in ((60, 100, 17, 32), (60, 100, 8, 129), (60, 0, 4, 32)):
        with pytest.raises(ValueError):
            K.bias_attention_plan(*args)


def test_bias_wide_plan_fits_every_shape_it_takes():
    """bias_attn_wide_kernel's plan over 1..16 heads x head dims 1..128 x
    K 1..128: its shared memory (bias_wide_smem, head_wide.cu bw_smem)
    fits a block; resident heads take one pass and may share a block's K
    and V over several tiles, else a tile a block and passes of at most a
    warp's worth of heads (BA_WIDE_WARPS) that cover the heads; the
    blocks of a batch row cover its query tiles."""
    plan_of = K._bias_attention_plan.__wrapped__
    seen = set()
    for heads in range(1, 17):
        for d in range(1, 129):
            for n in range(1, 129):
                if (heads, d) == (K.BA_HEADS, K.BA_D):
                    continue
                plan = dict(plan_of(60, n, heads, d))
                tiles = -(-n // 16)
                assert plan["wide"] and plan["key_tiles"] == tiles
                assert plan["d_pad"] == K.attention_head_dim(d)
                g, passes = plan["heads_per_pass"], plan["passes"]
                assert plan["smem_bytes"] == K.bias_wide_smem(
                    heads, tiles * 16, plan["d_pad"], g, plan["resident"])
                assert plan["smem_bytes"] <= K.ATT_SMEM_LIMIT
                assert (passes - 1) * g < heads <= passes * g
                if plan["resident"]:
                    assert (g, passes) == (heads, 1)
                else:
                    assert g <= K.BA_WIDE_WARPS
                    assert plan["tiles_per_block"] == 1
                assert plan["q_split"] * plan["tiles_per_block"] >= tiles
                assert (plan["q_split"] - 1) * plan["tiles_per_block"] < tiles
                seen.add((plan["resident"], passes > 1))
    assert seen == {(True, False), (False, False), (False, True)}
    # 60 batch rows still fill the card: K = 100 gives 7 tiles a row
    for heads, d in ((8, 25), (8, 64), (16, 32), (4, 128)):
        plan = K.bias_attention_plan(60, 100, heads, d)
        assert 60 * plan["q_split"] >= 132


@pytest.mark.parametrize("c", [1, 16, 100, 128, 129, 200, 255, 257, 384,
                               385, 511, 512])
def test_post_plan_wide_encoder_tile(c):
    """enc_post_wide_kernel's part of post_plan: tiles of ENC_WIDE_TILE
    rows, each of its two warpgroups holding `half` channels (half of c
    rounded up to 64: one of four instances), the weights padded to
    c_pad = 2 half channels and the hidden to whole chunks of
    ENC_WIDE_CHUNK, a ring of at least two slots a warpgroup, all in a
    block's shared memory."""
    for rows, f in ((60 * 356, 300), (510 * 356, 1024), (129, 1), (1, 64)):
        plan = K.post_plan(rows, c, f)
        if c == K.POST_C:
            assert "kernels" not in plan
            continue
        half = plan["half"]
        assert half in (64, 128, 192, 256) and half == K.enc_wide_half(c)
        assert half - 64 < -(-c // 2) <= half
        assert plan["c_pad"] == 2 * half >= c
        assert plan["f_pad"] % K.ENC_WIDE_CHUNK == 0
        assert plan["f_pad"] - K.ENC_WIDE_CHUNK < f <= plan["f_pad"]
        assert plan["chunks"] == plan["f_pad"] // K.ENC_WIDE_CHUNK
        assert plan["tiles"] == -(-rows // K.ENC_WIDE_TILE)
        assert plan["pad_rows"] == plan["tiles"] * K.ENC_WIDE_TILE - rows
        slots, smem = K.enc_wide_ring(c)
        enc = plan["kernels"]["enc_post_wide_kernel"]
        assert enc["slots"] == slots and 2 <= slots <= K.ENC_WIDE_SLOTS
        assert enc["smem_bytes"] == smem
        assert smem <= plan["smem_bytes"] <= K.ATT_SMEM_LIMIT
    assert "enc_post_wide_kernel" not in K.post_plan(
        700, 200, 300, chunk=K.DEC_CHUNK, keypoints=100)["kernels"]


@pytest.mark.parametrize("c", [1, 16, 100, 200, 384, 511, 512])
@pytest.mark.parametrize("k", [1, 64, 65, 100, 128])
def test_decoder_wide_plan_fits_and_covers_every_row(c, k):
    """The wide decoder kernels' part of post_plan (csrc/dec_wide.cuh): each
    kernel's rings of at least four WIDE_BOX slots a warpgroup in a block's
    shared memory (dec_wide_rings, dw_smem); the self and cross kernels'
    tiles of ENC_WIDE_TILE flattened rows and the gcn kernel's tiles of
    ENC_WIDE_TILE rows of one batch row cover every row once, a last tile
    partly filled where the rows are no multiple of 64 (`pad_rows`,
    `gcn_pad_rows`); C, 2C and F fit the padded widths in whole boxes and
    chunks."""
    tile = K.ENC_WIDE_TILE
    partial = set()
    for b, f in ((1, 1), (7, 300), (60, 1024), (3, 3000)):
        # the self kernel's rows need be no batch of keypoint rows
        for rows, kp in ((b * k, None), (b * k + 5, None), (b * k, k)):
            plan = K.post_plan(rows, c, f, chunk=K.DEC_CHUNK, keypoints=kp)
            assert plan["wide"] and plan["half"] == K.enc_wide_half(c)
            assert plan["c_pad"] == 2 * plan["half"] >= c
            assert plan["c2_pad"] == 2 * plan["c_pad"] >= 2 * c
            assert plan["f_pad"] % K.ENC_WIDE_CHUNK == 0
            assert plan["f_pad"] - K.ENC_WIDE_CHUNK < f <= plan["f_pad"]
            assert plan["chunks"] == plan["f_pad"] // K.ENC_WIDE_CHUNK
            rings = K.dec_wide_rings(c)
            for name, kern in plan["kernels"].items():
                if name == "enc_post_wide_kernel":
                    continue
                assert (kern["slots"], kern["smem_bytes"]) == rings[name]
                assert 4 <= kern["slots"] <= K.ENC_WIDE_SLOTS
                assert kern["smem_bytes"] <= plan["smem_bytes"] \
                    <= K.ATT_SMEM_LIMIT
            # the flattened rows: every row in exactly one tile
            cover = [t * tile + i for t in range(plan["tiles"])
                     for i in range(tile) if t * tile + i < rows]
            assert cover == list(range(rows))
            assert plan["pad_rows"] == plan["tiles"] * tile - rows
            assert 0 <= plan["pad_rows"] < tile
            partial.add(plan["pad_rows"] > 0)
            if kp is None:
                assert "gcn_tiles" not in plan
                continue
            # the gcn kernel: ceil(K / 64) tiles a batch row, each row of
            # each batch row in one of them
            kt = -(-k // tile)
            assert plan["gcn_tiles"] == b * kt
            seen = [(g // kt, (g % kt) * tile + i)
                    for g in range(plan["gcn_tiles"]) for i in range(tile)
                    if (g % kt) * tile + i < k]
            assert seen == [(bi, i) for bi in range(b) for i in range(k)]
            assert plan["gcn_pad_rows"] == kt * tile - k
            partial.add(plan["gcn_pad_rows"] > 0)
    assert True in partial            # a last tile only partly filled


@pytest.mark.parametrize("c,h,ffn", WIDTHS)
def test_width_misfits_take_the_six_widths(c, h, ffn):
    out = K.width_misfits(_width_cfg(c, h, ffn))
    assert all(why is None for why in out.values()), out


@pytest.mark.parametrize("cfg,vit,op,why", [
    (ModelConfig(**STAGE3), (768, 12, 3000), "fused_vit_block",
     "hidden width 3000 is not a positive multiple of 64"),
    (ModelConfig(**STAGE3), (1088, 17), "fused_vit_block",
     "64..1024 channels in steps of 64, got 1088"),
    (ModelConfig(**STAGE3), (1024, 4), "fused_vit_block",
     "head dims up to 128, got 256 (1024 channels in 4 heads)"),
    (_width_cfg(1024, 8, 2048), None, "fused_decoder_layer",
     "head dims 1..128, got 256"),
    (_width_cfg(384, 2, 768), None, "flash_mha (encoder)",
     "head dims 1..128, got 192"),
    (_width_cfg(1088, 17, 2176, max_kpt=160), None, "fused_decoder_stack",
     "the bias attention takes 1..16 heads of 1..128, got 17 of 64"),
], ids=["vit-768/12", "vit-1088/17", "vit-1024/4", "d_model-1024",
        "head-dim-192", "K-160"])
def test_what_stays_refused_is_named(cfg, vit, op, why):
    """ViT-B/14's 768 channels in 12 heads are taken (the wide route):
    what stays refused of it is an MLP hidden off the 64-column grid. No
    head width is refused by its channels: 1024 channels in 8 heads by the
    cross-attention's head dim of 256, 1088 in 17 (at 160 keypoints) by
    the Markov bias's 17 heads."""
    kw = {} if vit is None else dict(zip(("vit_dim", "vit_heads",
                                          "vit_hidden"), vit))
    out = K.width_misfits(cfg, **kw)
    assert out[op] is not None and why in out[op], out[op]


# ------------------------------------------------------------- padding
def test_pad_heads_lays_out_zero_columns():
    t = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).view(2, 3, 20)
    p = K.pad_heads(t, 4, 32)
    assert p.shape == (2, 3, 128)
    heads = p.view(2, 3, 4, 32)
    assert torch.equal(heads[..., :5], t.view(2, 3, 4, 5))
    assert not heads[..., 5:].any()
    assert torch.equal(K.unpad_heads(p, 4, 5), t)
    assert K.pad_heads(t, 4, 5) is t and K.unpad_heads(t, 4, 5) is t


def test_weight_padding_is_exact():
    """pad_ffn / pad_gcn / pad_cols: zero rows and columns that change no
    product (the FFN on padded weights equals it unpadded to fp32 noise:
    the zeros add +0, the sums are only grouped otherwise) and leave the
    weights themselves where no padding is needed."""
    g = torch.Generator().manual_seed(0)
    w1, b1, w2 = (torch.randn(300, 200, generator=g), torch.randn(
        300, generator=g), torch.randn(200, 300, generator=g))
    x = torch.randn(7, 200, generator=g)
    p1, pb1, p2 = K.pad_ffn(w1, b1, w2, 320, 208)
    assert p1.shape == (320, 208) and p2.shape == (208, 320)
    xp = torch.cat([x, torch.zeros(7, 8)], 1)
    ref = torch.relu(x @ w1.t() + b1) @ w2.t()
    got = torch.relu(xp @ p1.t() + pb1) @ p2.t()
    assert not got[:, 200:].any()
    torch.testing.assert_close(got[:, :200], ref, rtol=0, atol=1e-4)
    wg, bg, wf = (torch.randn(600, 200, generator=g),
                  torch.randn(600, generator=g),
                  torch.randn(200, 300, generator=g))
    gp, gbp, fp = K.pad_gcn(wg, bg, wf, 320)
    assert torch.equal(gp[:300], wg[:300]) and torch.equal(
        gp[320:620], wg[300:]) and not gp[300:320].any()
    assert torch.equal(gbp[320:620], bg[300:]) and fp.shape == (200, 320)
    same = K.pad_ffn(w1, b1, w2, 300)
    assert same[0] is w1 and same[2] is w2


@pytest.mark.parametrize("d", [25, 50])
@pytest.mark.parametrize("nq,nk", [(100, 100), (100, 256)])
def test_padded_attention_matches_jax_flash_mha(d, nq, nk):
    """The eval kernels' form at a padded head dim: plain attention on
    pad_heads' q, k, v with the true scale, the padding dropped, against
    the JAX flash_mha (Pallas, interpret mode) on the unpadded heads."""
    rng = np.random.default_rng(d + nk)
    b, h = 2, 2
    q = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, nk, h, d)).astype(np.float32)
            for _ in range(2))
    valid = rng.uniform(size=(b, nk)) > 0.3
    valid[:, 0] = True
    ref = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(valid), interpret=True)
    dp = K.attention_head_dim(d)
    tq, tk, tv = (K.pad_heads(torch.from_numpy(t).reshape(b, -1, h * d), h,
                              dp) for t in (q, k, v))
    out = plain.attention(tq, tk, tv, num_heads=h, scale=d ** -0.5,
                          kb=plain.key_bias(torch.from_numpy(valid)))
    out = K.unpad_heads(out, h, d).reshape(b, nq, h, d)
    diff = np.abs(out.numpy() - np.asarray(ref, np.float32))
    assert diff.max() <= 2 ** -7 * 2, diff.max()
    assert diff.mean() <= 1e-3, diff.mean()


@pytest.mark.parametrize("d", [25, 50])
def test_padded_training_attention_matches_jax(d):
    """The training pair's form at a padded head dim: the plain
    flash_mha_train on padded heads, forward and gradients of q, k, v and
    the bias, against the JAX training kernels in interpret mode on the
    unpadded heads (the bounds of tests/test_torch_attention_plan.py)."""
    rng = np.random.default_rng(d)
    b, n, h = 1, 100, 2
    q, k, v, g = (rng.normal(size=(b, n, h, d)).astype(np.float32)
                  for _ in range(4))
    bias = (0.3 * rng.normal(size=(b, h, n, n))).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[:, 0] = True
    jargs = [jnp.asarray(t) for t in (q, k, v, bias)]
    jvalid = jnp.asarray(valid)

    def jloss(q, k, v, bias):
        return jnp.sum(jflash.flash_mha_train(q, k, v, jvalid, bias,
                                              interpret=True) * g)

    jout = jflash.flash_mha_train(*jargs[:3], jvalid, jargs[3],
                                  interpret=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    dp = K.attention_head_dim(d)
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v, bias)]
    padded = [K.pad_heads(t.reshape(b, n, h * d), h, dp).view(b, n, h, dp)
              for t in leaves[:3]]
    tout = tflash.flash_mha_train_plain(*padded, torch.from_numpy(valid),
                                        leaves[3], scale=d ** -0.5)
    tout = K.unpad_heads(tout.reshape(b, n, h * dp), h, d).view(b, n, h, d)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=0.02, rtol=0.02)
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(g))
    for name, tg, jg in zip(("dq", "dk", "dv", "dbias"), tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=0.05,
                                   rtol=0.05, err_msg=name)


def test_prepared_weights_follow_the_plan():
    """The fused ops' `_prepare` lays out the weights the kernels read:
    at 256 channels as they are (hidden padded to its chunks), elsewhere
    the encoder's padded to c_pad channels and f_pad hidden columns, the
    decoder's to c_pad, 2C to c2_pad and the GCN width to f_pad, the
    GEMMs' weights as they are; and the 256-channel kernels' inputs stay the
    parameters themselves where no padding is needed."""
    enc = EncoderLayer(200, 8, 300)
    w = tenc._prepare(enc)
    assert w["wo"].shape == (256, 256) and w["w1"].shape == (384, 256)
    assert w["w2"].shape == (256, 384) and w["b1"].shape == (384,)
    assert w["wqkv"].shape == (600, 200) and w["bo"].shape == (200,)
    dec = DecoderLayer(200, 8, 300)
    w = tdec._prepare(dec)
    assert w["wso"].shape == (256, 256) and w["wcq_x"].shape == (512, 256)
    assert w["wco"].shape == (512, 512) and w["wch"].shape == (256, 512)
    assert w["wg"].shape == (768, 256) and w["bg"].shape == (768,)
    assert w["wf"].shape == (256, 384) and w["wck_img"].shape == (400, 200)
    w = tenc._prepare(EncoderLayer(256, 8, 300))
    assert w["w1"].shape == (384, 256) and w["wo"].shape == (256, 256)
    ref = EncoderLayer(256, 8, 384)
    w = tenc._prepare(ref)
    assert torch.equal(w["w1"], ref.linear1.weight.detach().to(
        torch.bfloat16))


def test_the_cpu_route_takes_any_width_without_launches():
    """On CPU tensors the ops are their plain versions at any width and
    count nothing (the card's route at these widths is the kernels')."""
    cfg = dataclasses.replace(_width_cfg(200, 8, 300))
    assert K.width_misfits(cfg)["fused_decoder_stack"] is None
    n0 = dict(K.launches)
    layer = EncoderLayer(200, 8, 300).eval()
    tok = torch.randn(2, 10, 200)
    with torch.no_grad():
        out = tenc.fused_encoder_layer(tok, torch.randn(10, 200),
                                       torch.ones(2, 10, dtype=torch.bool),
                                       layer, num_heads=8)
    assert out.shape == tok.shape and K.launches == n0


def test_kpt_clock_copy_marks_every_phase():
    """tools/bench_kpt_head.py's clock copy of csrc/kpt_wide.cu finds every
    line it marks (the tile's start, the rows in, each layer's first pass
    and end, the coordinates out) and refuses a source without them."""
    from edgecape_tpu_torch.tools import bench_kpt_head as BK
    src = open(os.path.join(K.CSRC, "kpt_wide.cu")).read()
    out = BK._instrumented(src)
    assert out.count("KW_MARK(") == 6 and "kw_clock_read" in out
    assert out.count("++tile_n;") == 1
    with pytest.raises(SystemExit):
        BK._instrumented(src.replace("// h is whole in the next boxes", ""))
