"""The order of operations of the port's post-attention kernels
(csrc/kernels.cu enc_post_kernel, dec_post_self_kernel,
dec_post_cross_kernel), emulated tile by tile in plain PyTorch on the CPU:
tiles of 128 rows whose missing rows the TMA fills with zeros, the FFN
hidden in chunks (128 wide in the encoder, 64 in the decoder) with the
second product accumulated onto the LayerNorm output it is added to, the
cross-attention query as one accumulation over [x1; qpos], o2 in
64-column pieces each fed to the choker, one batch row of K keypoints a
tile padded to 128 rows with zero adjacency rows and columns. Held
against the ops' plain versions and, for whole layers, against the JAX
Pallas kernels in interpret mode. At the other widths (C 128, 200 with
its padding, 512) the same for their wide forms (csrc/head_wide.cu,
csrc/dec_self_wide.cu, csrc/dec_wide.cu): tiles of 64 rows (missing rows
zero, the residual read as row R - 1), the channels padded to twice the
warpgroups' half width (2C to twice that) and the hidden to chunks of 128
by zero rows and columns of the prepared weights, LayerNorm over the true
C;
enc_post_wide_kernel's FFN second product accumulated onto the LN1 output
and its bias added after; the decoder's q2 in 128-column chunks, o2 in
128-column chunks each fed to the choker at once, y of the flattened rows
formed before the adjacency contraction, which takes tiles of 64 rows of
one batch row and keys in boxes of 64, the GCN's ffn2 summed apart and
added with its bias; and the 256-channel kernels on an FFN of 300, padded
to its chunks. Also: the tile plan of ops/kernels.py post_plan,
the weight cache of kernels.module_weights and the wrappers' refusal of
CPU operands.

Tolerances. Emulation against the plain version: the same bf16 rounding
points and the same weights, only the fp32 sums are grouped otherwise, so
the two agree to fp32 noise carried through LayerNorm, except where that
noise flips a bf16 rounding of an intermediate (one ulp, 2^-8 relative,
on a few elements): max within ULP_MAX, mean within NOISE_MEAN. Against
the JAX kernels, the bounds of tests/test_torch_fused_ops.py (BF16_MAX,
BF16_MEAN), for the reasons given there."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import fused_decoder as jdec
from edgecape_tpu.ops import fused_encoder as jenc
from edgecape_tpu_torch.models.convert import state_from_flax
from edgecape_tpu_torch.models.transformer import DecoderLayer, EncoderLayer
from edgecape_tpu_torch.ops import fused_decoder as tdec
from edgecape_tpu_torch.ops import fused_encoder as tenc
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain

ULP_MAX, NOISE_MEAN = 2.0 ** -6, 1e-4
BF16_MAX, BF16_MEAN = 0.0625, 0.004
TILE = K.POST_TILE
C, F, HEADS = 256, 384, 8


def _ln(x, w, g, b, eps=1e-5):
    return plain.layer_norm(x, w[g], w[b], eps)


def _tiles(t, pad_value=None, size=TILE):
    """t [R, ...] cut into tiles of `size` rows; the last one's missing
    rows zero (the TMA's fill) or, with pad_value="last", row R - 1."""
    r = t.shape[0]
    pad = (-r) % size
    fill = t[-1:].expand(pad, *t.shape[1:]) if pad_value == "last" \
        else t.new_zeros((pad,) + t.shape[1:])
    return torch.cat([t, fill]).split(size)


# ------------------------------------------------------------- emulations
def enc_post_tiled(att, src, w, eps=1e-5, chunk=K.ENC_CHUNK):
    """enc_post_kernel's order on att, src [R, C]: fp32 [R, C]."""
    r = att.shape[0]
    f = w["w1"].shape[0]
    out = []
    for a_t, s_t in zip(_tiles(att), _tiles(src, "last")):
        x = _ln(plain.linear(a_t, w["wo"]) + w["bo"] + plain.bf16(s_t), w,
                "g1", "be1")
        xb = plain.bf16(x)
        for j in range(0, f, chunk):
            h = plain.bf16(torch.relu(plain.linear(xb, w["w1"][j:j + chunk])
                                      + w["b1"][j:j + chunk]))
            x = x + plain.linear(h, w["w2"][:, j:j + chunk])
        out.append(_ln(x + w["b2"], w, "g2", "be2"))
    return torch.cat(out)[:r]


def dec_post_self_tiled(att, xb, qpos, w, eps=1e-5):
    """dec_post_self_kernel's order: (x1 fp32 [R, C], q2 [R, 2C] holding
    bf16 values)."""
    r, c = att.shape
    x1s, q2s = [], []
    for a_t, x_t, q_t in zip(_tiles(att), _tiles(xb, "last"), _tiles(qpos)):
        x1 = _ln(plain.linear(a_t, w["wso"]) + w["bso"] + plain.bf16(x_t), w,
                 "g1", "be1")
        halves = [plain.linear(x1, w["wcq_x"][h:h + c])
                  + plain.linear(q_t, w["wcq_p"][h:h + c]) + w["bcq"][h:h + c]
                  for h in (0, c)]
        x1s.append(x1)
        q2s.append(plain.bf16(torch.cat(halves, -1)))
    return torch.cat(x1s)[:r], torch.cat(q2s)[:r]


def dec_post_cross_tiled(att2, x1, adj, w, eps=1e-5, chunk=K.DEC_CHUNK):
    """dec_post_cross_kernel's order, one batch row of K keypoints a tile
    padded to TILE rows: att2 [B, K, 2C], x1 [B K, C], adj [B, 2, K, K]
    -> fp32 [B K, C]."""
    b, k, c2 = att2.shape
    c = c2 // 2
    f = w["wf"].shape[1]
    out = []
    for bi in range(b):
        a_t = att2.new_zeros(TILE, c2)
        a_t[:k] = att2[bi]
        x1_t = x1.new_zeros(TILE, c)
        x1_t[:k] = x1[bi * k:(bi + 1) * k]
        adj_t = torch.zeros(2, TILE, TILE)
        adj_t[:, :k, :k] = plain.bf16(adj[bi].float())
        acc = torch.zeros(TILE, c)
        for p in range(0, c2, 64):
            o = plain.bf16(plain.linear(a_t, w["wco"][p:p + 64])
                           + w["bco"][p:p + 64])
            acc = acc + plain.linear(o, w["wch"][:, p:p + 64])
        x = _ln(acc + w["bch"] + x1_t, w, "g2", "be2")
        xb = plain.bf16(x)
        for j in range(0, f, chunk):
            y0, y1 = (plain.bf16(plain.linear(xb, w["wg"][s + j:s + j + chunk])
                                 + w["bg"][s + j:s + j + chunk])
                      for s in (0, f))
            m = adj_t[0] @ y0 + adj_t[1] @ y1
            x = x + plain.linear(plain.bf16(torch.relu(m)),
                                 w["wf"][:, j:j + chunk])
        out.append(_ln(x + w["bf"], w, "g3", "be3")[:k])
    return torch.cat(out)


def _cols(t, n):
    """t [R, c] with zero columns up to n: a tile as the wide kernels hold
    it in shared memory."""
    return torch.cat([t, t.new_zeros(t.shape[0], n - t.shape[1])], 1)


def enc_post_wide_tiled(att, src, w, eps=1e-5):
    """enc_post_wide_kernel's order on att, src [R, C] and the prepared
    weights (wo [Cq, Cq], w1 [Fq, Cq], w2 [Cq, Fq]: zero rows and columns
    past C and F): tiles of ENC_WIDE_TILE rows, x over the Cq padded
    channels (zero past C), the hidden in chunks of ENC_WIDE_CHUNK, each
    chunk's second product accumulated onto x, b2 added after: fp32
    [R, C]."""
    r, c = att.shape
    cp, fp = w["wo"].shape[0], w["w1"].shape[0]
    ch = K.ENC_WIDE_CHUNK
    out = []
    for a_t, s_t in zip(_tiles(att, size=K.ENC_WIDE_TILE),
                        _tiles(src, "last", size=K.ENC_WIDE_TILE)):
        x = plain.bf16(s_t) + (plain.linear(_cols(a_t, cp), w["wo"])[:, :c]
                               + w["bo"])
        x = _cols(_ln(x, w, "g1", "be1"), cp)
        xb = plain.bf16(x)
        for j in range(0, fp, ch):
            h = plain.bf16(torch.relu(plain.linear(xb, w["w1"][j:j + ch])
                                      + w["b1"][j:j + ch]))
            x = x + plain.linear(h, w["w2"][:, j:j + ch])
        out.append(_ln(x[:, :c] + w["b2"], w, "g2", "be2"))
    return torch.cat(out)[:r]


def dec_post_self_wide_tiled(att, xb, qpos, w, eps=1e-5):
    """dec_post_self_wide_kernel's order (csrc/dec_self_wide.cu) on att, xb,
    qpos [R, C] and the prepared weights (wso [Cq, Cq], wcq_x, wcq_p [C2q,
    Cq]: zero rows and columns past C and 2C): tiles of ENC_WIDE_TILE rows
    (missing rows zero, xb read as row R - 1), x1 over the Cq padded
    channels (zero past C), q2 in chunks of ENC_WIDE_CHUNK columns, each one
    accumulation over bf16(x1) then qpos: (x1 fp32 [R, C], q2 [R, 2C]
    holding bf16 values)."""
    r, c = att.shape
    cp, ch = w["wso"].shape[0], K.ENC_WIDE_CHUNK
    wq = torch.cat([w["wcq_x"], w["wcq_p"]], 1)
    x1s, q2s = [], []
    for a_t, x_t, q_t in zip(_tiles(att, size=K.ENC_WIDE_TILE),
                             _tiles(xb, "last", size=K.ENC_WIDE_TILE),
                             _tiles(qpos, size=K.ENC_WIDE_TILE)):
        x1 = _ln(plain.bf16(x_t) + (plain.linear(_cols(a_t, cp),
                                                 w["wso"])[:, :c]
                                    + w["bso"]), w, "g1", "be1")
        xq = torch.cat([_cols(x1, cp), _cols(q_t, cp)], 1)
        z = torch.cat([plain.linear(xq, wq[j:j + ch])
                       for j in range(0, wq.shape[0], ch)], 1)
        x1s.append(x1)
        q2s.append(plain.bf16(z[:, :2 * c] + w["bcq"]))
    return torch.cat(x1s)[:r], torch.cat(q2s)[:r]


def dec_post_cross_wide_tiled(att2, x1, adj, w, eps=1e-5):
    """The wide cross layer's two launches (csrc/dec_wide.cu):
    dec_post_cross_wide_kernel over the rows flattened over the batch in
    tiles of ENC_WIDE_TILE (missing rows zero, x1 read as row R - 1), o2 in
    chunks of ENC_WIDE_CHUNK columns each fed to the choker at once, LN2,
    y over the tile; then dec_post_gcn_wide_kernel over tiles of
    ENC_WIDE_TILE rows of one batch row: per chunk of ENC_WIDE_CHUNK GCN
    features m = adj0 . y0 + adj1 . y1 over keys in boxes of 64 (zero past
    K), one box product at a time into one sum, y0's kt = ceil(K / 64)
    boxes then y1's (the kernel's load units), bf16(relu(m)) . Wf^T
    summed apart, LN3(x2 + (f + bf)): fp32 [B K, C]. The same above
    POST_TILE keypoints at POST_C channels, where the wide pair takes the
    cross layer."""
    b, k, c2 = att2.shape
    c, r = c2 // 2, b * k
    cp, c2p, fp = w["wch"].shape[0], w["wco"].shape[0], w["wf"].shape[1]
    ch, tile = K.ENC_WIDE_CHUNK, K.ENC_WIDE_TILE
    bco = _cols(w["bco"][None], c2p)[0]
    x2s, ys = [], []
    for a_t, x_t in zip(_tiles(att2.reshape(r, c2), size=tile),
                        _tiles(x1, "last", size=tile)):
        acc = 0
        for j in range(0, c2p, ch):
            o = plain.bf16(plain.linear(_cols(a_t, c2p), w["wco"][j:j + ch])
                           + bco[j:j + ch])
            acc = acc + plain.linear(o, w["wch"][:, j:j + ch])
        x2 = _ln(x_t + (acc[:, :c] + w["bch"]), w, "g2", "be2")
        x2s.append(x2)
        ys.append(plain.bf16(plain.linear(_cols(x2, cp), w["wg"]) + w["bg"]))
    x2, y = torch.cat(x2s)[:r], torch.cat(ys)[:r]
    keys = -(-k // tile) * tile
    out = []
    for bi in range(b):
        yb = torch.zeros(keys, 2 * fp)
        yb[:k] = y[bi * k:(bi + 1) * k]
        for i0 in range(0, k, tile):
            n = min(tile, k - i0)
            a = torch.zeros(2, tile, keys)
            a[:, :n, :k] = plain.bf16(adj[bi, :, i0:i0 + n].float())
            f = 0
            for j in range(0, fp, ch):
                m = 0
                for s in range(2):
                    for q in range(0, keys, tile):
                        m = m + a[s][:, q:q + tile] @ yb[
                            q:q + tile, s * fp + j:s * fp + j + ch]
                f = f + plain.linear(plain.bf16(torch.relu(m)),
                                     w["wf"][:, j:j + ch])
            x2_t = x2[bi * k + i0:bi * k + i0 + n]
            out.append(_ln(x2_t + (f[:n, :c] + w["bf"]), w, "g3", "be3"))
    return torch.cat(out)


def encoder_layer_tiled(tokens, pos, valid, layer, *, num_heads=HEADS,
                        eps=1e-5):
    """A whole encoder layer as the card runs it: the op's prepared
    weights, the q, k, v product and attention as the plain version forms
    them, then the post-attention kernel's order."""
    w = tenc._prepare(layer)
    b, n, c = tokens.shape
    src = plain.bf16(plain.bf16(tokens) + plain.bf16(pos)[None])
    qkv = plain.linear(src, w["wqkv"], w["bqkv"])
    att = plain.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                          num_heads=num_heads,
                          scale=1.0 / math.sqrt(c // num_heads),
                          kb=plain.key_bias(valid))
    post = enc_post_tiled if c == K.POST_C else enc_post_wide_tiled
    y = post(att.reshape(b * n, c), src.reshape(b * n, c), w, eps)
    return y.view(b, n, c).to(tokens.dtype)


def decoder_layer_tiled(x, qpos, img, ipos, valid, bias, adj, layer, *,
                        num_heads=HEADS, eps=1e-5):
    """A whole decoder layer as the card runs it (see
    ops/fused_decoder.py)."""
    w = tdec._prepare(layer)
    b, k, c = x.shape
    r = b * k
    wide = c != K.POST_C
    long = k > K.POST_TILE           # the cross layer's wide pair at any c
    xb = plain.bf16(x)
    qkv = plain.linear(xb, w["wqkv"], w["bqkv"])
    att = plain.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                          num_heads=num_heads, scale=(c // num_heads) ** -0.5,
                          kb=plain.key_bias(valid), bias=bias)
    x1, q2 = (dec_post_self_wide_tiled if wide else dec_post_self_tiled)(
        att.reshape(r, c), xb.reshape(r, c), plain.bf16(qpos).reshape(r, c),
        w, eps)
    imgb = plain.bf16(img)
    kpos = plain.linear(plain.bf16(ipos), w["wck_pos"], w["bck"])
    k2 = plain.linear(imgb, w["wck_img"]) + kpos
    v2 = plain.linear(imgb, w["wcv"], w["bcv"])
    att2 = plain.attention(q2.view(b, k, 2 * c), k2, v2,
                           num_heads=num_heads,
                           scale=(2 * c // num_heads) ** -0.5)
    cross = dec_post_cross_wide_tiled if wide or long else \
        dec_post_cross_tiled
    return cross(att2, x1, adj, tdec.cross_weights(layer, w, k), eps).view(
        b, k, c).to(x.dtype)


# ------------------------------------------------------------- inputs
def _dense(rng, i, o):
    return {"kernel": (rng.normal(size=(i, o)) / math.sqrt(i)).astype(
        np.float32), "bias": (rng.normal(size=o) * 0.1).astype(np.float32)}


def _norm(rng, c):
    return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}


def _mha(rng, e, q_dim, v_dim):
    return {"q_proj": _dense(rng, q_dim, e), "k_proj": _dense(rng, q_dim, e),
            "v_proj": _dense(rng, v_dim, e), "out_proj": _dense(rng, e, e)}


def _encoder(rng, c=C, f=F, heads=HEADS):
    tree = {"self_attn": _mha(rng, c, c, c), "norm1": _norm(rng, c),
            "linear1": _dense(rng, c, f), "linear2": _dense(rng, f, c),
            "norm2": _norm(rng, c)}
    layer = EncoderLayer(c, heads, f)
    layer.load_state_dict(state_from_flax(tree))
    return tree, layer.eval()


def _decoder(rng, c=C, f=F, heads=HEADS):
    tree = {"self_attn": _mha(rng, c, c, c), "norm1": _norm(rng, c),
            "cross_attn": _mha(rng, 2 * c, 2 * c, c),
            "choker": _dense(rng, 2 * c, c), "norm2": _norm(rng, c),
            "gcn": {"conv": _dense(rng, c, 2 * f)},
            "ffn2": _dense(rng, f, c), "norm3": _norm(rng, c)}
    layer = DecoderLayer(c, heads, f)
    layer.load_state_dict(state_from_flax(tree))
    return tree, layer.eval()


def _encoder_args(tree):
    at = tree["self_attn"]
    return tuple(x for name in ("q_proj", "k_proj", "v_proj", "out_proj")
                 for x in (at[name]["kernel"], at[name]["bias"])) + (
        tree["norm1"]["scale"], tree["norm1"]["bias"],
        tree["linear1"]["kernel"], tree["linear1"]["bias"],
        tree["linear2"]["kernel"], tree["linear2"]["bias"],
        tree["norm2"]["scale"], tree["norm2"]["bias"])


def _decoder_inputs(rng, b, k, hw, c=C, heads=HEADS):
    x, qpos = (rng.normal(size=(b, k, c)).astype(np.float32)
               for _ in range(2))
    img = rng.normal(size=(b, hw, c)).astype(np.float32)
    ipos = rng.normal(size=(hw, c)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.3
    valid[:, 0] = True
    bias = rng.normal(size=(b, heads, k, k)).astype(np.float32)
    adj = rng.uniform(size=(b, 2, k, k)).astype(np.float32) / k
    return x, qpos, img, ipos, valid, bias, adj


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else t,
                      np.float32)


def _close(out, ref, max_tol=ULP_MAX, mean_tol=NOISE_MEAN):
    d = np.abs(_np(out) - _np(ref))
    assert np.isfinite(d).all()
    assert d.max() <= max_tol, d.max()
    assert d.mean() <= mean_tol, d.mean()


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("b,n", [(3, 50), (1, 128), (2, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_emulation_matches_the_plain_layer(b, n, dtype):
    """150 rows (a whole tile and a ragged one), exactly one tile, fewer
    rows than a tile."""
    rng = np.random.default_rng(10)
    _, layer = _encoder(rng)
    tokens = torch.from_numpy(rng.normal(size=(b, n, C)).astype(
        np.float32)).to(dtype)
    pos = torch.from_numpy(rng.normal(size=(n, C)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(b, n)) > 0.3)
    valid[:, 0] = True
    with torch.no_grad():
        out = encoder_layer_tiled(tokens, pos, valid, layer)
        ref = tenc.fused_encoder_layer_plain(tokens, pos, valid, layer,
                                             num_heads=HEADS)
    assert out.dtype == dtype
    _close(out, ref)


def test_encoder_stack_emulation_matches_the_plain_stack():
    """The stack adds the position once and each layer's kernel forms the
    next src = bf16(bf16(y) + pos): the same values as the chain of
    layers, each adding the position to the last one's output."""
    rng = np.random.default_rng(11)
    layers = [_encoder(rng)[1] for _ in range(2)]
    tokens = torch.from_numpy(rng.normal(size=(2, 70, C)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(rng.normal(size=(70, C)).astype(np.float32))
    valid = torch.ones(2, 70, dtype=torch.bool)
    with torch.no_grad():
        x = tokens
        for layer in layers:
            x = encoder_layer_tiled(x, pos, valid, layer)
        ref = tenc.fused_encoder_stack(tokens, pos, valid, layers,
                                       num_heads=HEADS)
    # the second layer carries the first one's bf16 flips on: ten times
    # the one layer's mean bound
    _close(x, ref, mean_tol=10 * NOISE_MEAN)


@pytest.mark.parametrize("b,k,hw", [(2, 100, 24), (3, 13, 20), (1, 128, 16)])
def test_decoder_emulation_matches_the_plain_layer(b, k, hw):
    """K = 100 (the path's, padded by 28 rows), a small K, K = 128 (no
    padding)."""
    rng = np.random.default_rng(12)
    _, layer = _decoder(rng)
    x, qpos, img, ipos, valid, bias, adj = (
        torch.from_numpy(a) for a in _decoder_inputs(rng, b, k, hw))
    x, qpos, img, ipos = (t.to(torch.bfloat16) for t in (x, qpos, img, ipos))
    with torch.no_grad():
        out = decoder_layer_tiled(x, qpos, img, ipos, valid, bias, adj, layer)
        ref = tdec.fused_decoder_layer_plain(x, qpos, img, ipos, valid, bias,
                                             adj, layer, num_heads=HEADS)
    assert out.dtype == torch.bfloat16
    _close(out, ref)


def test_cross_tile_padding_contributes_nothing():
    """Rows past K hold values (LayerNorm of the padded zero rows), yet
    the zero adjacency columns keep them out of the K rows: filling the
    padded rows' inputs otherwise changes no kept row."""
    rng = np.random.default_rng(13)
    _, layer = _decoder(rng)
    w = tdec._prepare(layer)
    b, k = 2, 37
    att2 = plain.bf16(torch.from_numpy(rng.normal(size=(b, k, 2 * C)).astype(
        np.float32)))
    x1 = torch.from_numpy(rng.normal(size=(b * k, C)).astype(np.float32))
    adj = torch.from_numpy(rng.uniform(size=(b, 2, k, k)).astype(
        np.float32)) / k
    with torch.no_grad():
        out = dec_post_cross_tiled(att2, x1, adj, w)
        # the same rows as the first K of a batch row of K + 5 keypoints
        # whose extra keypoints no adjacency entry reaches
        k5 = k + 5
        att2b = torch.cat([att2, torch.ones(b, 5, 2 * C)], 1)
        x1b = torch.cat([x1.view(b, k, C), torch.ones(b, 5, C)], 1)
        adjb = torch.zeros(b, 2, k5, k5)
        adjb[:, :, :k, :k] = adj
        big = dec_post_cross_tiled(att2b, x1b.reshape(b * k5, C), adjb, w)
    assert torch.equal(out.view(b, k, C), big.view(b, k5, C)[:, :k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_emulation_matches_jax_kernel(dtype):
    rng = np.random.default_rng(14)
    tree, layer = _encoder(rng)
    b, n = 2, 30
    tokens = rng.normal(size=(b, n, C)).astype(np.float32)
    pos = rng.normal(size=(n, C)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[:, 0] = True
    ref = jenc.fused_encoder_layer(
        jnp.asarray(tokens).astype(dtype), jnp.asarray(pos),
        jnp.asarray(valid), *_encoder_args(tree), num_heads=HEADS, eps=1e-5,
        interpret=True)
    with torch.no_grad():
        out = encoder_layer_tiled(
            torch.from_numpy(tokens).to(getattr(torch, dtype)),
            torch.from_numpy(pos), torch.from_numpy(valid), layer)
    _close(out, ref.astype(jnp.float32), BF16_MAX, BF16_MEAN)


def test_decoder_emulation_matches_jax_kernel():
    rng = np.random.default_rng(15)
    tree, layer = _decoder(rng)
    x, qpos, img, ipos, valid, bias, adj = _decoder_inputs(rng, 2, 12, 16)
    ref = jdec.fused_decoder_layer(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, qpos, img, ipos)),
        jnp.asarray(valid), jnp.asarray(bias), jnp.asarray(adj), tree,
        num_heads=HEADS, eps=1e-5, interpret=True)
    tx = [torch.from_numpy(a).to(torch.bfloat16)
          for a in (x, qpos, img, ipos)]
    with torch.no_grad():
        out = decoder_layer_tiled(*tx, torch.from_numpy(valid),
                                  torch.from_numpy(bias),
                                  torch.from_numpy(adj), layer)
    _close(out, ref.astype(jnp.float32), BF16_MAX, BF16_MEAN)


# widths of the head_wide.cu kernels (C, FFN, heads): head dims 16 / 32,
# 25 / 50 (C and FFN padded), 64 / 128 at 512 channels; and the
# 256-channel kernels on an FFN of 300, padded to their chunks
WIDE = [(128, 256, 8), (200, 300, 8), (512, 1024, 8), (256, 300, 8)]


@pytest.mark.parametrize("c,f,heads", WIDE)
def test_wide_encoder_emulation_matches_the_plain_layer(c, f, heads):
    """40 rows a batch row, 80 in all: a whole 64-row tile of
    enc_post_wide_kernel and a ragged one."""
    rng = np.random.default_rng(c + f)
    _, layer = _encoder(rng, c, f, heads)
    b, n = 2, 40
    tokens = torch.from_numpy(rng.normal(size=(b, n, c)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(b, n)) > 0.3)
    valid[:, 0] = True
    with torch.no_grad():
        out = encoder_layer_tiled(tokens, pos, valid, layer, num_heads=heads)
        ref = tenc.fused_encoder_layer_plain(tokens, pos, valid, layer,
                                             num_heads=heads)
    _close(out, ref)


@pytest.mark.parametrize("c,f,heads", WIDE)
def test_wide_decoder_emulation_matches_the_plain_layer(c, f, heads):
    """K = 37 (a ragged last tile of the cross kernel's batch row)."""
    rng = np.random.default_rng(c + f + 1)
    _, layer = _decoder(rng, c, f, heads)
    x, qpos, img, ipos, valid, bias, adj = (
        torch.from_numpy(a) for a in _decoder_inputs(rng, 2, 37, 16, c,
                                                     heads))
    x, qpos, img, ipos = (t.to(torch.bfloat16) for t in (x, qpos, img, ipos))
    with torch.no_grad():
        out = decoder_layer_tiled(x, qpos, img, ipos, valid, bias, adj, layer,
                                  num_heads=heads)
        ref = tdec.fused_decoder_layer_plain(x, qpos, img, ipos, valid, bias,
                                             adj, layer, num_heads=heads)
    _close(out, ref)


@pytest.mark.parametrize("c,f,heads", [(128, 256, 8), (200, 300, 8)])
@pytest.mark.parametrize("k", [65, 100])
def test_wide_decoder_emulation_takes_two_gcn_tiles_a_batch_row(c, f, heads,
                                                               k):
    """K above 64: dec_post_gcn_wide_kernel takes a batch row in two tiles
    of 64 rows (the second partly filled), keys in two boxes of 64. fp32
    tokens, so that the layer's output is not rounded to bf16 (at this
    many rows some output lies above 4, where one bf16 ulp exceeds
    ULP_MAX). The tiling does not depend on C; at 512 channels the
    intermediates' bf16 flips over 2 x 100 rows put the mean at the
    NOISE_MEAN bound itself, and that width is held at K 37 above and on
    the card."""
    rng = np.random.default_rng(c + k)
    _, layer = _decoder(rng, c, f, heads)
    x, qpos, img, ipos, valid, bias, adj = (
        torch.from_numpy(a) for a in _decoder_inputs(rng, 2, k, 16, c,
                                                     heads))
    with torch.no_grad():
        out = decoder_layer_tiled(x, qpos, img, ipos, valid, bias, adj, layer,
                                  num_heads=heads)
        ref = tdec.fused_decoder_layer_plain(x, qpos, img, ipos, valid, bias,
                                             adj, layer, num_heads=heads)
    _close(out, ref)


def test_wide_layers_at_200_channels_match_jax_kernels():
    """d_model 200 in 8 heads (head dims 25 and 50), FFN 300: the
    emulated wide kernels on the padded weights against the JAX Pallas
    layers in interpret mode on the unpadded ones."""
    c, f, heads = 200, 300, 8
    rng = np.random.default_rng(16)
    tree, layer = _encoder(rng, c, f, heads)
    b, n = 2, 30
    tokens = rng.normal(size=(b, n, c)).astype(np.float32)
    pos = rng.normal(size=(n, c)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[:, 0] = True
    ref = jenc.fused_encoder_layer(
        jnp.asarray(tokens).astype(jnp.bfloat16), jnp.asarray(pos),
        jnp.asarray(valid), *_encoder_args(tree), num_heads=heads, eps=1e-5,
        interpret=True)
    with torch.no_grad():
        out = encoder_layer_tiled(
            torch.from_numpy(tokens).to(torch.bfloat16),
            torch.from_numpy(pos), torch.from_numpy(valid), layer,
            num_heads=heads)
    _close(out, ref.astype(jnp.float32), BF16_MAX, BF16_MEAN)
    tree, layer = _decoder(rng, c, f, heads)
    x, qpos, img, ipos, valid, bias, adj = _decoder_inputs(rng, 2, 12, 16, c,
                                                           heads)
    ref = jdec.fused_decoder_layer(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, qpos, img, ipos)),
        jnp.asarray(valid), jnp.asarray(bias), jnp.asarray(adj), tree,
        num_heads=heads, eps=1e-5, interpret=True)
    tx = [torch.from_numpy(a).to(torch.bfloat16)
          for a in (x, qpos, img, ipos)]
    with torch.no_grad():
        out = decoder_layer_tiled(*tx, torch.from_numpy(valid),
                                  torch.from_numpy(bias),
                                  torch.from_numpy(adj), layer,
                                  num_heads=heads)
    _close(out, ref.astype(jnp.float32), BF16_MAX, BF16_MEAN)


# rows, hidden, chunk, keypoints -> tiles, chunks, padded rows: the eval
# chunk's encoder (510 x 356 rows), decoder self (510 x 100) and cross
# (510 batch rows of K = 100) kernels, and edges
PLANS = [((181560, 384, 128, None), (1419, 3, 72)),
         ((51000, 128, 128, None), (399, 1, 72)),
         ((51000, 384, 64, 100), (510, 6, 28)),
         ((128, 128, 128, None), (1, 1, 0)),
         ((1, 128, 128, None), (1, 1, 127)),
         ((128, 64, 64, 128), (1, 1, 0)),
         ((7, 64, 64, 1), (7, 1, 127))]


@pytest.mark.parametrize("args,want", PLANS)
def test_post_plan_tiles_and_padding(args, want):
    rows, f, chunk, k = args
    plan = K.post_plan(rows, K.POST_C, f, chunk=chunk, keypoints=k)
    assert (plan["tiles"], plan["chunks"], plan["pad_rows"]) == want


@pytest.mark.parametrize("args,kw", [
    ((100, 0, 96), {}),                        # no channels
    ((100, 256, 0), {}),                       # no hidden
    ((129, 256, 384), {"chunk": 64, "keypoints": 0}),    # no keypoints
    ((150, 256, 384), {"chunk": 64, "keypoints": 100}),  # no whole rows
    ((0, 256, 384), {})])
def test_post_plan_refuses_what_the_kernels_do_not_take(args, kw):
    with pytest.raises(ValueError):
        K.post_plan(*args, **kw)


def test_weight_cache_follows_a_parameter_write():
    """The prepared weights are made once; a write into a parameter, a
    load_state_dict or a cast makes them anew."""
    rng = np.random.default_rng(16)
    _, layer = _encoder(rng)
    _, other = _encoder(rng)
    builds = []

    def build(m):
        builds.append(1)
        return tenc._prepare(m)

    first = K.module_weights(layer, "_kernel_weights", build)
    assert K.module_weights(layer, "_kernel_weights", build) is first
    b1 = layer.linear1.bias.detach().clone()
    with torch.no_grad():
        layer.linear1.bias.add_(1.0)
    second = K.module_weights(layer, "_kernel_weights", build)
    assert second is not first and len(builds) == 2
    assert torch.equal(second["b1"], b1 + 1.0)
    layer.load_state_dict(other.state_dict())
    third = K.module_weights(layer, "_kernel_weights", build)
    assert torch.equal(third["wo"], tenc._prepare(other)["wo"])
    layer.to(torch.bfloat16)
    assert K.module_weights(layer, "_kernel_weights", build) is not third
    assert len(builds) == 4
    assert first["wqkv"].dtype == torch.bfloat16 and first["wqkv"].shape == (
        3 * C, C)


def test_post_kernels_refuse_cpu_operands_and_count_nothing():
    rng = np.random.default_rng(17)
    _, enc = _encoder(rng)
    _, dec = _decoder(rng)
    we, wd = tenc._prepare(enc), tdec._prepare(dec)
    att = torch.zeros(10, C, dtype=torch.bfloat16)
    before = dict(K.launches)
    with pytest.raises(ValueError):
        K.enc_post(att, att, we, eps=1e-5, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        K.dec_post_self(att, att, att, wd, eps=1e-5)
    with pytest.raises(ValueError):
        K.dec_post_cross(torch.zeros(1, 10, 2 * C, dtype=torch.bfloat16),
                         torch.zeros(10, C), torch.zeros(1, 2, 10, 10), wd,
                         eps=1e-5, out_dtype=torch.float32)
    assert K.launches == before
