"""More than 128 keypoints a batch row (COCO-WholeBody's 133, Halpe's 136):
the decoder kernels' routes above 128 keypoints, on the CPU.

* The plans: above POST_TILE keypoints the cross layer takes the wide pair
  at every width, 256 channels included (dec_post_cross_wide_kernel over
  the flattened rows, dec_post_gcn_wide_kernel over ceil(K / 64) tiles of
  64 rows a batch row, its adjacency window of DEC_ADJ_LONG boxes), and
  the bias attention takes bias_attn_long_kernel (csrc/bias_long.cu); at
  128 keypoints and fewer both plans stay as they were, and the gcn
  kernel's rings keep their figures. width_misfits refuses no keypoint
  count.
* The emulations (tests/test_torch_fused_post.py dec_post_cross_wide_tiled,
  tests/test_torch_decoder_stack.py bias_attention_long_tiled), tile by
  tile in plain PyTorch, against the plain versions at K 133 (the real
  count), 256 (whole key tiles) and 300 (a ragged last tile), with
  invalid keypoints in some batch rows: ULP_MAX / NOISE_MEAN of
  tests/test_torch_fused_post.py.
* Why the streamed bias attention normalises p before rounding it: a
  one-pass online softmax, which rounds the unnormalised p, misses
  NOISE_MEAN against the plain version on the same inputs.
* The emulated decoder layer and stack against the JAX Pallas kernels in
  interpret mode at K = 133 (d_model 64 in 4 heads, batch 2; the 256-
  channel layout at batch 1): the layer to tests/test_torch_fused_post.py's
  BF16_MAX / BF16_MEAN; the stack, one layer, to the bounds a stack layer
  is held to against its plain version (STACK_LAYER_MAX / STACK_LAYER_MEAN
  of tests/test_torch_decoder_stack.py and chip_smoke.py). The 1e-4 of
  tests/test_torch_variant_ops.py, met at 64 channels and K = 12, holds
  neither here: at 256 channels the port's plain stack and the JAX kernel
  differ by more than 1e-4 at K = 12 already, and at K = 133 the card's
  order (the cross layer's wide pair, the streamed bias attention) flips
  bf16 roundings of the layer's tokens that the plain order does not,
  each moving a coordinate by about 1e-5 through the delta heads.
* The slice: a max_kpt = 133 stage-3 model at a small width, JAX weights
  mapped with convert.from_jax_params, the port's fp32 forward_cached
  against the JAX strict path to 1e-4 on normalised coordinates.

About 60 s in one process."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.api import PoseEstimator as JaxEstimator
from edgecape_tpu.models import dinov2 as jdinov2
from edgecape_tpu.ops import fused_decoder as jdec
from edgecape_tpu_torch.config import ModelConfig
from edgecape_tpu_torch.ops import fused_decoder as tdec
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain
from test_torch_decoder_stack import (QT, STACK_LAYER_MAX,
                                      STACK_LAYER_MEAN,
                                      bias_attention_long_tiled, decoder,
                                      decoder_tree, finished_scores,
                                      stack_tiled)
from test_torch_fused_post import (BF16_MAX, BF16_MEAN, NOISE_MEAN, ULP_MAX,
                                   _close, _decoder, _decoder_inputs,
                                   dec_post_cross_wide_tiled,
                                   decoder_layer_tiled)
from test_torch_slice import (COORD_TOL, SIZE, TRUNK, _cfg, _jax_estimator,
                              _perturb, _torch_estimator)

KPTS = [133, 256, 300]
T = torch.from_numpy


# ------------------------------------------------------------- plans
@pytest.mark.parametrize("k", [129, 133, 256, 300])
@pytest.mark.parametrize("c,h,f", [(256, 8, 384), (200, 8, 300)])
def test_plans_above_128_keypoints(k, c, h, f):
    """510 batch rows: the cross layer's wide pair at 256 channels too,
    the gcn kernel's tiles of 64 rows a batch row and its adjacency window
    of DEC_ADJ_LONG boxes; the streamed bias attention at 64-key tiles."""
    rows = 510 * k
    plan = K.post_plan(rows, c, f, chunk=K.DEC_CHUNK, keypoints=k)
    kt = -(-k // K.ENC_WIDE_TILE)
    assert plan["wide"] and set(plan["kernels"]) == {
        "dec_post_cross_wide_kernel", "dec_post_gcn_wide_kernel"}
    assert plan["c_pad"] == 2 * K.enc_wide_half(c) >= c
    assert plan["f_pad"] % K.ENC_WIDE_CHUNK == 0 and plan["f_pad"] >= f
    assert plan["tiles"] == -(-rows // K.ENC_WIDE_TILE)
    assert plan["gcn_tiles"] == 510 * kt
    assert plan["gcn_pad_rows"] == kt * K.ENC_WIDE_TILE - k
    assert plan["adj_boxes"] == K.DEC_ADJ_LONG
    gcn = plan["kernels"]["dec_post_gcn_wide_kernel"]
    assert (gcn["slots"], gcn["smem_bytes"]) == K.dec_wide_rings(c, k)[
        "dec_post_gcn_wide_kernel"]
    assert gcn["smem_bytes"] <= K.ATT_SMEM_LIMIT
    bp = K.bias_attention_plan(510, k, h, c // h)
    assert bp["long"] and bp["key_tile"] == 64
    assert bp["d_pad"] == K.attention_head_dim(c // h)
    assert bp["key_tiles"] == -(-k // 64) and bp["query_tiles"] == -(-k // 16)
    assert bp["smem_bytes"] <= K.ATT_SMEM_LIMIT
    # at 128 keypoints both plans are what they were
    assert "wide" not in K.post_plan(510 * 128, 256, f, chunk=K.DEC_CHUNK,
                                     keypoints=128)
    assert "long" not in K.bias_attention_plan(510, 128, h, c // h)


@pytest.mark.parametrize("heads,d", [(16, 32), (16, 64), (16, 128),
                                     (8, 128), (3, 25)])
def test_bias_long_plan_fits_every_head_shape(heads, d):
    """Up to 16 heads of head dim 128: the key tile shrinks (32 at 16
    heads of 64, 16 at 16 of 128) so that the block's shared memory
    fits; heads above 8 give each warp two heads."""
    plan = K.bias_attention_plan(60, 300, heads, d)
    dp = K.attention_head_dim(d)
    assert plan["long"] and plan["d_pad"] == dp
    assert plan["heads_per_warp"] == (2 if heads > 8 else 1)
    assert plan["key_tile"] == K.bias_long_key_tile(dp, heads)
    assert plan["smem_bytes"] == K.bias_long_smem(heads, dp,
                                                  plan["key_tile"])
    assert plan["smem_bytes"] <= K.ATT_SMEM_LIMIT
    assert plan["scratch_floats"] == heads * 16 * 304


@pytest.mark.parametrize("heads", [1, 3, 8, 16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_bias_long_smem_fits_every_head_shape_and_key_count(heads, d):
    """bias_attn_long_kernel at every head count and head dim it takes, K
    129 to 1024: shared memory within a block's 227 KB, as many blocks an
    SM as the launch bounds and the SM's shared memory allow, and a scratch
    of every 16-query tile's finished scores, [heads, 16, K padded to 16]
    a block."""
    for k in (129, 133, 136, 144, 145, 256, 300, 512, 1000, 1024):
        plan = K.bias_attention_plan(510, k, heads, d)
        kt = K.bias_long_key_tile(K.attention_head_dim(d), heads)
        assert plan["long"] and plan["key_tile"] == kt
        assert plan["smem_bytes"] <= K.ATT_SMEM_LIMIT
        assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) \
            <= K.BA_SM_SMEM
        assert plan["scratch_floats"] == heads * 16 * -(-k // 16) * 16
        assert plan["items"] == 510 * -(-k // 16)


def test_width_misfits_take_133_keypoints():
    """A stage-3 model with max_kpt 133 builds on the kernels at the
    port's head widths; a 1024-channel head in 8 heads stays refused by
    name, by its cross-attention's head dim of 256."""
    stage3 = dict(learn_skeleton=True, attn_bias=True, use_flash=True)
    for kw in ({}, dict(d_model=200, nhead=8, dim_feedforward=300,
                        num_feats=100, similarity_proj_dim=200)):
        out = K.width_misfits(ModelConfig(**stage3, max_kpt=133, **kw))
        assert all(why is None for why in out.values()), out
    out = K.width_misfits(ModelConfig(**stage3, max_kpt=133, d_model=1024,
                                      num_feats=512,
                                      similarity_proj_dim=1024))
    assert "head dims 1..128, got 256" in out["fused_decoder_stack"]


def test_dec_wide_rings_keep_their_figures_up_to_128_keypoints():
    """The gcn kernel's rings up to 128 keypoints are those before the
    long window existed (8 slots, 194 KB); above, 7 slots in 226 KB; the
    self and cross kernels' do not depend on K."""
    box, red = K.WIDE_BOX + 16, 4 * 2 * 2 * K.ENC_WIDE_TILE
    short = (8, 1024 + 8 * K.WIDE_BOX + red + 16 * box)
    long = (7, 1024 + 14 * K.WIDE_BOX + red + 14 * box)
    for c in (100, 200, 256, 512):
        for k in (1, 64, 100, 128):
            rings = K.dec_wide_rings(c, k)
            assert rings == K.dec_wide_rings(c)
            assert rings["dec_post_gcn_wide_kernel"] == short
        for k in (129, 133, 300, 1000):
            rings = K.dec_wide_rings(c, k)
            assert rings["dec_post_gcn_wide_kernel"] == long
            assert {n: r for n, r in rings.items() if "gcn" not in n} == {
                n: r for n, r in K.dec_wide_rings(c).items()
                if "gcn" not in n}
    assert K.dec_wide_rings(512)["dec_post_self_wide_kernel"][0] == 6
    assert K.dec_wide_rings(512)["dec_post_cross_wide_kernel"][0] == 4


# ------------------------------------------------------------- emulations
def _masked_adj(rng, b, k, valid):
    """Adjacency [B, 2, K, K] over the valid keypoints of each batch row
    (rows and columns of the invalid ones zero), as the model hands it."""
    adj = rng.uniform(size=(b, 2, k, k)).astype(np.float32) / k
    keep = valid[:, None, :, None] & valid[:, None, None, :]
    return np.where(keep, adj, 0.0).astype(np.float32)


def _valid(rng, b, k):
    """Keypoint masks: batch row 0 all valid (K of them), the others with
    the last ones invalid and some holes."""
    valid = rng.uniform(size=(b, k)) > 0.2
    valid[0] = True
    for i in range(1, b):
        valid[i, k - 17 * i:] = False
    valid[:, 0] = True
    return valid


@pytest.mark.parametrize("k", KPTS)
@pytest.mark.parametrize("c,f,heads", [(256, 384, 8), (200, 300, 8)])
def test_cross_layer_over_key_boxes_matches_plain(k, c, f, heads):
    """The cross layer's wide pair above 128 keypoints: the gcn kernel's
    ceil(K / 64) tiles a batch row and its key boxes, y0's then y1's, into
    one sum, against post_cross_plain (fp32 output, so that no output is
    rounded to bf16: an ulp of a value above 4 exceeds ULP_MAX)."""
    rng = np.random.default_rng(k + c)
    _, layer = _decoder(rng, c, f, heads)
    w = tdec.cross_weights(layer, tdec._prepare(layer), k)
    b = 2
    valid = _valid(rng, b, k)
    att2 = plain.bf16(T(rng.normal(size=(b, k, 2 * c)).astype(np.float32)))
    x1 = T(rng.normal(size=(b * k, c)).astype(np.float32))
    adj = T(_masked_adj(rng, b, k, valid))
    with torch.no_grad():
        out = dec_post_cross_wide_tiled(att2, x1, adj, w)
        ref = tdec.post_cross_plain(att2, x1.view(b, k, c), adj, layer)
    _close(out.view(b, k, c), ref)


def test_cross_weights_pad_the_gcn_to_whole_chunks_at_256_channels():
    """At 256 channels above 128 keypoints the wide pair reads the GCN in
    chunks of 128: an FFN of 320 is padded to 384 by zero rows and
    columns (made once, kept); the stage-3 FFN of 384 needs nothing."""
    rng = np.random.default_rng(2)
    _, layer = _decoder(rng, 256, 320, 8)
    w = tdec._prepare(layer)
    assert w["wf"].shape == (256, 320)
    assert tdec.cross_weights(layer, w, 100) is w
    wl = tdec.cross_weights(layer, w, 133)
    assert wl["wf"].shape == (256, 384) and wl["wg"].shape == (768, 256)
    assert not wl["wf"][:, 320:].any() and not wl["wg"][320:384].any()
    assert torch.equal(wl["wg"][384:704], w["wg"][320:])
    assert tdec.cross_weights(layer, w, 300) is wl
    _, layer = _decoder(rng, 256, 384, 8)
    w = tdec._prepare(layer)
    assert tdec.cross_weights(layer, w, 133) is w


def _bias_operands(seed, b, n, heads, d, nhop=5, hid=12):
    g = torch.Generator().manual_seed(seed)
    c = heads * d
    qkv = plain.bf16(torch.randn(b, n, 3 * c, generator=g))
    valid = T(_valid(np.random.default_rng(seed), b, n))
    hops = torch.rand(b, n, n, nhop, generator=g)
    mlp = (torch.randn(nhop, hid, generator=g),
           torch.randn(hid, generator=g) * 0.1,
           torch.randn(hid, heads, generator=g) / math.sqrt(hid),
           torch.randn(heads, generator=g) * 0.1)
    return qkv, valid, hops, mlp


@pytest.mark.parametrize("k", KPTS)
@pytest.mark.parametrize("heads,d", [(8, 32), (8, 64), (16, 32)])
def test_bias_attention_long_emulation_matches_plain(k, heads, d):
    """bias_attn_long_kernel's two passes over streamed key tiles at the
    stage-3 heads (8 of 32), at 512 channels in 8 heads of 64, and at 16
    heads (two a warp), against bias_attention_plain."""
    qkv, valid, hops, mlp = _bias_operands(k + d + heads, 2, k, heads, d)
    out = bias_attention_long_tiled(qkv, valid, hops, mlp, num_heads=heads)
    ref = tdec.bias_attention_plain(qkv, valid, hops, mlp, num_heads=heads)
    assert out.shape == (2, k, heads * d)
    _close(out, ref)


def _one_pass(qkv, valid, hops, mlp, *, num_heads):
    """A one-pass online softmax over the same finished scores and key
    tiles: p = 2^(s - running max) rounded to bf16 for P.V, the output and
    the sum rescaled at each new max, divided by the sum at the end."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // num_heads
    out = []
    for q0 in range(0, n, QT):
        s2, vp, kt = finished_scores(qkv, valid, hops, mlp,
                                     num_heads=num_heads, q0=q0)
        m = torch.full(s2.shape[:-1], -math.inf)
        lsum = torch.zeros_like(m)
        o = 0
        for t0 in range(0, s2.shape[-1], kt):
            st = s2[..., t0:t0 + kt]
            mn = torch.maximum(m, st.amax(-1))
            z = torch.where(mn == -math.inf, torch.zeros_like(mn), mn)
            a = torch.exp2(m - z)
            p = torch.exp2(st - z[..., None])
            lsum = lsum * a + p.sum(-1)
            o = o * a[..., None] + plain.bf16(p) @ vp[..., t0:t0 + kt, :]
            m = mn
        inv = torch.where(lsum > 0, 1.0 / lsum, torch.zeros_like(lsum))
        out.append(plain.bf16(o * inv[..., None]))
    o = torch.cat(out, 2)[:, :, :n].transpose(1, 2).reshape(b, n, -1)
    return K.unpad_heads(o, num_heads, d)


def test_one_pass_rounding_misses_the_noise_bound():
    """The kernel's design choice, on the same inputs at K 133: the
    two-pass form rounds p after normalising it, as the plain version
    does, and keeps within NOISE_MEAN; a one-pass online softmax rounds
    the unnormalised p, which moves about a third of the outputs across a
    bf16 rounding boundary, and its mean error exceeds NOISE_MEAN."""
    qkv, valid, hops, mlp = _bias_operands(133, 3, 133, 8, 32)
    ref = tdec.bias_attention_plain(qkv, valid, hops, mlp, num_heads=8)
    two = bias_attention_long_tiled(qkv, valid, hops, mlp, num_heads=8)
    one = _one_pass(qkv, valid, hops, mlp, num_heads=8)
    _close(two, ref)
    d_one = (one - ref).abs()
    assert d_one.max().item() <= ULP_MAX
    assert d_one.mean().item() > NOISE_MEAN
    assert (two - ref).abs().mean().item() < d_one.mean().item() / 10


# ------------------------------------------------------------- JAX kernels
@pytest.mark.parametrize("c,heads,ff,b", [(64, 4, 128, 2), (256, 8, 384, 1)])
def test_decoder_layer_emulation_matches_jax_kernel_at_133(c, heads, ff, b):
    """The card's order of one decoder layer (the cross layer on the wide
    pair) against the JAX fused_decoder_layer in interpret mode, which
    pads K to 256."""
    rng = np.random.default_rng(c + 133)
    tree, layer = _decoder(rng, c, ff, heads)
    x, qpos, img, ipos, _, bias, _ = _decoder_inputs(rng, b, 133, 16, c,
                                                     heads)
    valid = _valid(rng, b, 133)
    adj = _masked_adj(rng, b, 133, valid)
    ref = jdec.fused_decoder_layer(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, qpos, img, ipos)),
        jnp.asarray(valid), jnp.asarray(bias), jnp.asarray(adj), tree,
        num_heads=heads, eps=1e-5, interpret=True)
    with torch.no_grad():
        out = decoder_layer_tiled(
            *(T(a).to(torch.bfloat16) for a in (x, qpos, img, ipos)),
            T(valid), T(bias), T(adj), layer, num_heads=heads)
    _close(out, ref.astype(jnp.float32), BF16_MAX, BF16_MEAN)


@pytest.mark.parametrize("c,heads,ff,b", [(64, 4, 128, 2), (256, 8, 384, 1)])
def test_stack_emulation_matches_jax_kernel_at_133(c, heads, ff, b):
    """The card's order of the decoder stack (the streamed bias attention,
    the cross layer's wide pair) against the JAX fused_decoder_stack in
    interpret mode, one layer, on coordinates in [0, 1] (see the module
    docstring for the bound)."""
    rng = np.random.default_rng(c + 134)
    nf, k = c // 2, 133
    tree = decoder_tree(rng, c, heads, ff, 1)
    valid = _valid(rng, b, k)
    inp = dict(
        x=(rng.normal(size=(b, k, c)) * 0.5).astype(np.float32),
        coords=rng.uniform(0.1, 0.9, size=(b, k, 2)).astype(np.float32),
        img=(rng.normal(size=(b, 16, c)) * 0.5).astype(np.float32),
        ipos=(rng.normal(size=(16, c)) * 0.5).astype(np.float32),
        valid=valid,
        hops=rng.uniform(0, 1, size=(b, k, k, 5)).astype(np.float32),
        adj=_masked_adj(rng, b, k, valid))
    lp = ({"dec": tree["layer0"], "kpt": tree["kpt_branch0"],
           "bias_mlp": tree["layer0"]["bias_mlp"]},)
    jo, jp = jdec.fused_decoder_stack(
        jnp.asarray(inp["x"]).astype(jnp.bfloat16),
        *(jnp.asarray(inp[n]) for n in ("coords", "img", "ipos", "valid",
                                         "hops", "adj")),
        lp, tree["ref_point_head"], tree["norm"], num_heads=heads,
        num_feats=nf, eps=1e-5, interpret=True)
    args = (T(inp["x"]).to(torch.bfloat16), T(inp["coords"]), T(inp["img"]),
            T(inp["ipos"]), T(inp["valid"]), T(inp["hops"]), T(inp["adj"]))
    o, p = stack_tiled(*args, decoder(tree, c, heads, ff, 1, nf),
                       num_heads=heads, num_feats=nf)
    assert o.shape == (1, b, k, 2)
    for t, j in ((o, jo), (p, jp)):
        d = np.abs(t.numpy() - np.asarray(j, np.float32))
        assert d.max() <= STACK_LAYER_MAX, d.max()
        assert d.mean() <= STACK_LAYER_MEAN, d.mean()


# ------------------------------------------------------------- the slice
NARROW = dict(d_model=64, nhead=4, num_feats=32, dim_feedforward=128,
              similarity_proj_dim=64)


def test_forward_cached_at_133_keypoints_matches_jax_strict():
    """A max_kpt = 133 stage-3 model at d_model 64 over the toy trunk of
    tests/test_torch_slice.py: one group of 133 valid keypoints and one of
    100, the port's fp32 forward_cached against the JAX strict path."""
    k = 133
    cfg = _cfg(max_kpt=k, **NARROW)
    bb = jdinov2.init_params(jax.random.PRNGKey(0), SIZE, TRUNK)
    est = JaxEstimator(cfg, backbone_params=bb, rng=jax.random.PRNGKey(1))
    weights = _perturb(bb, est.head_params, seed=8)
    rng = np.random.default_rng(133)
    adj = np.zeros((2, k, k), np.float32)
    for i in range(k - 1):
        adj[:, i, i + 1] = adj[:, i + 1, i] = 1.0
    vis = np.ones((2, 1, k), np.float32)
    vis[1, 0, 100:] = 0.0
    adj[1, 100:] = adj[1, :, 100:] = 0.0
    support = {
        "img_s": rng.integers(0, 256, (2, 1, SIZE, SIZE, 3), dtype=np.uint8),
        "joints_s": rng.uniform(4, SIZE - 4, (2, 1, k, 2)).astype(np.float32),
        "vis_s": vis, "binary_adj": adj}
    query = {"img_q": rng.integers(0, 256, (4, SIZE, SIZE, 3),
                                   dtype=np.uint8),
             "group": np.repeat(np.arange(2, dtype=np.int32), 2)}
    jpred, jadj = _jax_estimator(cfg, weights).forward_cached(support, query)
    tpred, tadj = _torch_estimator(cfg, weights).forward_cached(support,
                                                                query)
    assert tpred.shape == (4, k, 2)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)
