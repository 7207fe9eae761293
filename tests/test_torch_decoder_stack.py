"""The order of operations of the decoder stack's own kernels
(csrc/kernels.cu bias_attn_kernel, kpt_head_kernel) and of the stack as
the card runs it (ops/fused_decoder.py _fused_decoder_stack_cuda),
emulated tile by tile in plain PyTorch on the CPU:

* the bias attention: per 16-query tile the Markov bias MLP's hidden layer
  formed once per (query, key) in the kernel's order (b1, the hop terms
  ascending, ReLU; b2 and the hidden terms ascending), all heads' biases
  from it, then each head's attention (csrc/head_wide.cu
  bias_attn_wide_kernel at other head counts and dims: the same order,
  each head's q, k and v padded with zero columns to 32, 64 or 128);
  above 128 keypoints bias_attn_long_kernel (csrc/bias_long.cu): the
  finished scores in base 2 tile by tile of streamed keys, each lane's
  running max and exp-sum over a tile, joined over the quad, then the
  probabilities normalised before their bf16 rounding and P.V 16 keys at
  a time;
* the keypoint head: tiles of 64 keypoint rows (missing rows zero, the
  TMA's fill), the raw rows and their final norm, three GELU products
  rounded to bf16, the N = 2 head summed as four column groups (a row's
  256 values lie over a quad of threads), the coordinate update;
* the stack: per layer the sine embedding and ref_point_head, the qkv
  product, the bias attention, the post-attention kernels' order
  (tests/test_torch_fused_post.py), the cross-attention on the layer's
  keys and values, the keypoint head.

Held against the plain versions (ops/fused_decoder.py bias_attention_plain,
kpt_head_plain, fused_decoder_stack_plain) and, for the stack, against the
JAX Pallas kernel in interpret mode. The kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances. Bias attention against plain: the same bf16 rounding points,
the bias summed in another order (fp32 noise), so outputs agree except
where the noise flips a bf16 rounding: ULP_MAX / NOISE_MEAN of
tests/test_torch_fused_post.py. Keypoint head: coordinates in [0, 1]
through delta heads of 0.02; a flipped bf16 rounding of one hidden value
(2^-8 of a value of order 1) moves a coordinate by about 1e-5, so max
COORD_MAX and mean COORD_MEAN. A stack layer against the plain layer: the
bounds chip_smoke.py holds the kernel to (STACK_LAYER_MAX, STACK_LAYER_MEAN:
a few such ulps, and dec_post_cross adding ffn2 onto the LN2 output);
against the JAX kernel, the bound of tests/test_torch_variant_ops.py."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import fused_decoder as jdec
from edgecape_tpu_torch.models.convert import state_from_flax
from edgecape_tpu_torch.models.transformer import Decoder
from edgecape_tpu_torch.ops import fused_decoder as tdec
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain
from edgecape_tpu_torch.ops.pos_enc import inverse_sigmoid

from test_torch_fused_post import (NOISE_MEAN, ULP_MAX, dec_post_cross_tiled,
                                   dec_post_cross_wide_tiled,
                                   dec_post_self_tiled,
                                   dec_post_self_wide_tiled)

COORD_MAX, COORD_MEAN = 1e-4, 2e-6
STACK_LAYER_MAX, STACK_LAYER_MEAN = 2e-3, 1e-4
KH_ROWS, QT = 64, 16
T = torch.from_numpy


# ------------------------------------------------------------- emulations
def bias_attention_tiled(qkv, valid, hops, hop_mlp, *, num_heads):
    """bias_attn_kernel's order on qkv [B, K, 3C], hops [B, K, K, n_hop]
    (and bias_attn_wide_kernel's at any other head count and dim: each
    head's q, k and v padded by zero columns to attention_head_dim, the
    scale of the true dim): [B, K, C] fp32 holding bf16 values."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dp = K.attention_head_dim(d)
    q, k, v = (K.pad_heads(qkv[..., i * c:(i + 1) * c], num_heads, dp)
               for i in range(3))
    w1, b1, w2, b2 = (t.float() for t in hop_mlp)
    nhop, hid = w1.shape
    out = []
    for q0 in range(0, n, QT):
        hv = plain.bf16(hops[:, q0:q0 + QT])              # [B, t, K, n_hop]
        hidden = []
        for m in range(hid):
            a = b1[m].expand(hv.shape[:-1])
            for j in range(nhop):
                a = a + hv[..., j] * w1[j, m]
            hidden.append(torch.relu(a))
        bias = []
        for h in range(num_heads):
            acc = b2[h].expand(hv.shape[:-1])
            for m in range(hid):
                acc = acc + hidden[m] * w2[m, h]
            bias.append(acc)
        out.append(plain.attention(
            q[:, q0:q0 + QT], k, v, num_heads=num_heads, scale=d ** -0.5,
            kb=plain.key_bias(valid), bias=torch.stack(bias, 1)))
    return K.unpad_heads(torch.cat(out, 1), num_heads, d)


LOG2E = 1.4426950408889634


def finished_scores(qkv, valid, hops, hop_mlp, *, num_heads, q0):
    """What bias_attn_long_kernel's pass 1 writes for the 16-query tile
    from q0: log2(e) (q.k^T scale) + (log2(e) bias + key mask), the bias
    in the kernel's MLP order, each head's q and k padded to
    attention_head_dim, rows past K zero, keys padded with -inf to whole
    tiles of the plan's key_tile: ([B, H, 16, keys] fp32, the heads' v
    [B, H, keys, dp] with zero rows past K, the key tile)."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dp = K.attention_head_dim(d)
    kt = K.bias_attention_plan(b, n, num_heads, d)["key_tile"]
    keys = -(-n // kt) * kt
    q, k, v = (plain.bf16(K.pad_heads(qkv[..., i * c:(i + 1) * c],
                                      num_heads, dp))
               .view(b, n, num_heads, dp).transpose(1, 2)
               for i in range(3))
    qt = torch.zeros(b, num_heads, QT, dp)
    rows = min(QT, n - q0)
    qt[:, :, :rows] = q[:, :, q0:q0 + rows]
    hv = torch.zeros(b, QT, n, hops.shape[-1])
    hv[:, :rows] = plain.bf16(hops[:, q0:q0 + rows])
    w1, b1, w2, b2 = (t.float() for t in hop_mlp)
    nhop, hid = w1.shape
    hidden = []
    for m in range(hid):
        a = b1[m].expand(hv.shape[:-1])
        for j in range(nhop):
            a = a + hv[..., j] * w1[j, m]
        hidden.append(torch.relu(a))
    bias = []
    for h in range(num_heads):
        acc = b2[h].expand(hv.shape[:-1])
        for m in range(hid):
            acc = acc + hidden[m] * w2[m, h]
        bias.append(acc)
    bias = torch.stack(bias, 1)                       # [B, H, 16, K]
    sc2 = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    kb = plain.key_bias(valid)[:, None, None, :]
    s2 = (qt @ k.transpose(-1, -2)) * sc2 + (bias * LOG2E + kb)
    s2 = torch.nn.functional.pad(s2, (0, keys - n), value=-math.inf)
    vp = torch.nn.functional.pad(v, (0, 0, 0, keys - n))
    return s2, vp, kt


def bias_attention_long_tiled(qkv, valid, hops, hop_mlp, *, num_heads):
    """bias_attn_long_kernel's order (csrc/bias_long.cu) on qkv [B, K,
    3C], K above 128: per 16-query tile its finished scores
    (finished_scores); pass 1 over the key tiles in order, each lane's
    running max and exp-sum (lane t holds keys 4t .. 4t + 3 of every 16,
    its sum adding keys 4t, 4t + 1 then 4t + 2, 4t + 3 of each block in
    turn) rescaled to the tile's new max, then joined over the quad
    ((l0 + l1) + (l2 + l3)); pass 2: p = 2^(s - max) / sum rounded to
    bf16, P.V 16 keys at a time, the output rounded to bf16. Returns
    [B, K, C] fp32 holding bf16 values."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    out = []
    for q0 in range(0, n, QT):
        s2, vp, kt = finished_scores(qkv, valid, hops, hop_mlp,
                                     num_heads=num_heads, q0=q0)
        keys = s2.shape[-1]
        m = torch.full(s2.shape[:-1] + (4,), -math.inf)
        lsum = torch.zeros_like(m)
        for t0 in range(0, keys, kt):
            ch = s2[..., t0:t0 + kt].reshape(*s2.shape[:-1], kt // 16, 4, 4)
            cm = torch.maximum(m, ch.amax(dim=(-3, -1)))
            z = torch.where(cm == -math.inf, torch.zeros_like(cm), cm)
            ex = torch.exp2(ch - z[..., None, :, None])
            a = torch.zeros_like(lsum)
            for jb in range(kt // 16):
                a = a + (ex[..., jb, :, 0] + ex[..., jb, :, 1])
                a = a + (ex[..., jb, :, 2] + ex[..., jb, :, 3])
            lsum = lsum * torch.exp2(m - z) + a
            m = cm
        f = m.amax(-1)
        fz = torch.where(f == -math.inf, torch.zeros_like(f), f)
        lt = lsum * torch.exp2(m - fz[..., None])
        total = (lt[..., 0] + lt[..., 1]) + (lt[..., 2] + lt[..., 3])
        inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
        p = torch.exp2(s2 - fz[..., None]) * inv[..., None]
        o = 0
        for b0 in range(0, keys, 16):
            o = o + plain.bf16(p[..., b0:b0 + 16]) @ vp[..., b0:b0 + 16, :]
        out.append(plain.bf16(o))
    o = torch.cat(out, 2)[:, :, :n].transpose(1, 2).reshape(b, n, -1)
    return K.unpad_heads(o, num_heads, d)


def kpt_head_tiled(x, ct, fn, kpt, kow, kob, eps=1e-5):
    """kpt_head_kernel's order on x [R, C]: (pts, outs) fp32 [R, 2]."""
    r, c = x.shape
    pad = (-r) % KH_ROWS
    xp = torch.cat([x.float(), x.new_zeros(pad, c).float()])
    # the column group (thread of a quad) that sums each column of dd
    group = (torch.arange(c) // 2) % 4
    res = []
    for x_t in xp.split(KH_ROWS):
        halves = []
        for h in (x_t, plain.bf16(plain.layer_norm(x_t, *fn, eps))):
            for w, bb in kpt:
                h = plain.bf16(plain.gelu(plain.linear(h, w) + bb))
            parts = [h[:, group == t] @ plain.bf16(kow)[:, group == t].t()
                     for t in range(4)]
            halves.append(((parts[0] + parts[1]) + (parts[2] + parts[3]))
                          + kob.float())
        res.append(torch.stack(halves))
    dd = torch.cat(res, 1)[:, :r]                        # [2, R, 2]
    inv = inverse_sigmoid(ct.float())
    return torch.sigmoid(inv + dd[0]), torch.sigmoid(inv + dd[1])


def _sine_feats(ct, rdt):
    ax = (ct[:, 0:1] * 6.283185307179586) * rdt
    ay = (ct[:, 1:2] * 6.283185307179586) * rdt
    return plain.bf16(torch.cat([torch.sin(ay), torch.cos(ay), torch.sin(ax),
                                 torch.cos(ax)], -1))


@torch.no_grad()
def stack_tiled(x, coords, img, ipos, valid, hops, adj, dec, *, num_heads,
                num_feats, eps=1e-5):
    """The stack in the card's order (see ops/fused_decoder.py): (outputs,
    points) fp32 [L, B, K, 2]."""
    b, k, c = x.shape
    r = b * k
    w = tdec._build_stack_weights(dec, num_feats, hops is not None)
    xb = plain.bf16(x).reshape(r, c)
    ct = coords.float().reshape(r, 2)
    imgb, iposb = plain.bf16(img), plain.bf16(ipos)
    outs, pts = [], []
    wide = c != K.POST_C
    long = k > K.POST_TILE           # the cross layer's wide pair at any c
    post_self = dec_post_self_wide_tiled if wide else dec_post_self_tiled
    post_cross = dec_post_cross_wide_tiled if wide or long else \
        dec_post_cross_tiled
    bias_att = bias_attention_long_tiled if k > K.BA_RESIDENT_KEYS else \
        bias_attention_tiled
    for layer, sw in zip(dec.layers, w["layers"]):
        lw = tdec._prepare(layer)
        h = plain.bf16(plain.gelu(plain.linear(_sine_feats(ct, w["rdt"]),
                                               w["fc1p"], w["rb1"])))
        qpos = plain.bf16(plain.linear(h, w["fc2"], w["rb2"]))
        qkv = plain.bf16(plain.linear(xb, lw["wqkv"], lw["bqkv"])).view(
            b, k, 3 * c)
        if hops is not None:
            att = bias_att(qkv, valid, hops, sw["hop_mlp"],
                           num_heads=num_heads)
        else:
            att = plain.attention(qkv[..., :c], qkv[..., c:2 * c],
                                  qkv[..., 2 * c:], num_heads=num_heads,
                                  scale=(c // num_heads) ** -0.5,
                                  kb=plain.key_bias(valid))
        x1, q2 = post_self(att.reshape(r, c), xb, qpos, lw, eps)
        kpos = plain.linear(iposb, lw["wck_pos"], lw["bck"])
        k2 = plain.bf16(plain.linear(imgb, lw["wck_img"]) + kpos)
        v2 = plain.bf16(plain.linear(imgb, lw["wcv"], lw["bcv"]))
        att2 = plain.attention(q2.view(b, k, 2 * c), k2, v2,
                               num_heads=num_heads,
                               scale=(2 * c // num_heads) ** -0.5)
        xb = plain.bf16(post_cross(att2, x1, adj,
                                   tdec.cross_weights(layer, lw, k), eps))
        p, o = kpt_head_tiled(xb, ct, w["fn"], sw["kpt"], sw["kow"],
                              sw["kob"], eps)
        pts.append(p.view(b, k, 2))
        outs.append(o.view(b, k, 2))
        ct = p
    return torch.stack(outs), torch.stack(pts)


# ------------------------------------------------------------- inputs
def _dense(rng, i, o, s=None):
    s = 1.0 / math.sqrt(i) if s is None else s
    return {"kernel": (rng.normal(size=(i, o)) * s).astype(np.float32),
            "bias": (rng.normal(size=o) * (0.1 if s > 0.05 else s)).astype(
                np.float32)}


def _ln(rng, c):
    return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}


def _mha(rng, e, q_dim, v_dim):
    return {"q_proj": _dense(rng, q_dim, e), "k_proj": _dense(rng, q_dim, e),
            "v_proj": _dense(rng, v_dim, e), "out_proj": _dense(rng, e, e)}


def decoder_tree(rng, c, heads, ff, layers, hops=4, bias=True):
    tree = {"ref_point_head": {"fc1": _dense(rng, c, c),
                               "fc2": _dense(rng, c, c)},
            "norm": _ln(rng, c)}
    for i in range(layers):
        lt = {"self_attn": _mha(rng, c, c, c), "norm1": _ln(rng, c),
              "cross_attn": _mha(rng, 2 * c, 2 * c, c),
              "choker": _dense(rng, 2 * c, c), "norm2": _ln(rng, c),
              "gcn": {"conv": _dense(rng, c, 2 * ff)},
              "ffn2": _dense(rng, ff, c), "norm3": _ln(rng, c)}
        if bias:
            lt["bias_mlp"] = {"fc1": _dense(rng, hops + 1, hops + heads),
                              "fc2": _dense(rng, hops + heads, heads)}
        tree[f"layer{i}"] = lt
        kb = {f"fc{j}": _dense(rng, c, c) for j in range(3)}
        kb["out"] = _dense(rng, c, 2, s=0.02)
        tree[f"kpt_branch{i}"] = kb
    return tree


def decoder(tree, c, heads, ff, layers, nf, bias=True):
    dec = Decoder(c, heads, ff, layers, attn_bias=bias, max_hops=4,
                  num_feats=nf).eval()
    dec.load_state_dict(state_from_flax(tree))
    return dec


def decoder_inputs(rng, b, k, hw, c):
    valid = rng.uniform(size=(b, k)) > 0.3
    valid[:, 0] = True
    return dict(
        x=(rng.normal(size=(b, k, c)) * 0.5).astype(np.float32),
        coords=rng.uniform(0.1, 0.9, size=(b, k, 2)).astype(np.float32),
        img=(rng.normal(size=(b, hw, c)) * 0.5).astype(np.float32),
        ipos=(rng.normal(size=(hw, c)) * 0.5).astype(np.float32),
        valid=valid,
        hops=rng.uniform(0, 1, size=(b, k, k, 5)).astype(np.float32),
        adj=(rng.uniform(size=(b, 2, k, k)) / k).astype(np.float32))


def _args(inp, bias=True):
    return (T(inp["x"]).to(torch.bfloat16), T(inp["coords"]), T(inp["img"]),
            T(inp["ipos"]), T(inp["valid"]),
            T(inp["hops"]) if bias else None, T(inp["adj"]))


def _close(out, ref, max_tol, mean_tol):
    d = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out).all())
    assert d.max().item() <= max_tol, d.max().item()
    assert d.mean().item() <= mean_tol, d.mean().item()


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("b,n,nhop,hid,heads,d", [
    (3, 100, 5, 12, 8, 32),     # the model's shape, 7 query tiles, ragged
    (2, 16, 5, 12, 8, 32),      # exactly one tile
    (2, 37, 3, 7, 2, 32),       # other MLP widths, fewer heads
    # bias_attn_wide_kernel at the [widths] head dims (chip_smoke.py
    # WIDTHS: 128 / 8, 200 / 8, 256 / 4, 384 / 8, 512 / 16 and 512 / 8)
    # and head dim 128, each padded to 32, 64 or 128
    (2, 100, 5, 12, 8, 16), (2, 100, 5, 12, 8, 25), (2, 37, 5, 8, 4, 64),
    (2, 100, 5, 12, 8, 48), (1, 100, 5, 20, 16, 32), (2, 128, 5, 12, 8, 64),
    (2, 37, 5, 8, 4, 128)])
def test_bias_attention_emulation_matches_plain(b, n, nhop, hid, heads, d):
    g = torch.Generator().manual_seed(n + hid)
    c = d * heads
    qkv = plain.bf16(torch.randn(b, n, 3 * c, generator=g))
    valid = torch.rand(b, n, generator=g) > 0.3
    valid[:, 0] = True
    hops = torch.rand(b, n, n, nhop, generator=g)
    mlp = (torch.randn(nhop, hid, generator=g),
           torch.randn(hid, generator=g) * 0.1,
           torch.randn(hid, heads, generator=g) / math.sqrt(hid),
           torch.randn(heads, generator=g) * 0.1)
    out = bias_attention_tiled(qkv, valid, hops, mlp, num_heads=heads)
    ref = tdec.bias_attention_plain(qkv, valid, hops, mlp, num_heads=heads)
    assert out.shape == (b, n, c)
    _close(out, ref, ULP_MAX, NOISE_MEAN)


def test_bias_attention_plain_is_the_stack_plain_bias():
    """bias_attention_plain's bias is the plain stack's (fc1, ReLU, fc2
    over the bf16 hop stack, [B, H, K, K]): the attention with it matches
    plain.attention handed the module's own bias."""
    rng = np.random.default_rng(3)
    tree = decoder_tree(rng, 64, 2, 96, 1)
    dec = decoder(tree, 64, 2, 96, 1, 32)
    g = torch.Generator().manual_seed(3)
    qkv = plain.bf16(torch.randn(2, 12, 192, generator=g))
    valid = torch.ones(2, 12, dtype=torch.bool)
    hops = plain.bf16(torch.rand(2, 12, 12, 5, generator=g))
    w = tdec._build_stack_weights(dec, 32, True)["layers"][0]
    with torch.no_grad():
        bias = dec.layers[0].bias_mlp(hops)                  # [B, H, K, K]
        ref = plain.attention(qkv[..., :64], qkv[..., 64:128],
                              qkv[..., 128:], num_heads=2,
                              scale=32 ** -0.5, kb=plain.key_bias(valid),
                              bias=bias)
    out = tdec.bias_attention_plain(qkv, valid, hops, w["hop_mlp"],
                                    num_heads=2)
    _close(out, ref, ULP_MAX, NOISE_MEAN)


@pytest.mark.parametrize("r", [51 * 5, 64, 13])
def test_kpt_head_emulation_matches_plain(r):
    """Several tiles with a ragged last one, exactly one tile, fewer rows
    than a tile."""
    g = torch.Generator().manual_seed(r)
    c = 256
    x = plain.bf16(torch.randn(r, c, generator=g))
    ct = torch.rand(r, 2, generator=g)
    ct[0] = torch.tensor([0.0, 1.0])                     # clipped ends
    fn = (1 + 0.1 * torch.randn(c, generator=g),
          0.1 * torch.randn(c, generator=g))
    kpt = [(torch.randn(c, c, generator=g) / 16, 0.1 * torch.randn(
        c, generator=g)) for _ in range(3)]
    kow, kob = (0.02 * torch.randn(2, c, generator=g),
                0.02 * torch.randn(2, generator=g))
    pts, outs = kpt_head_tiled(x, ct, fn, kpt, kow, kob)
    rp, ro = tdec.kpt_head_plain(x, ct, fn, kpt, kow, kob, eps=1e-5)
    for a, ref in ((pts, rp), (outs, ro)):
        assert a.shape == (r, 2) and a.dtype == torch.float32
        _close(a, ref, COORD_MAX, COORD_MEAN)


@pytest.mark.parametrize("bias", [True, False])
def test_stack_emulation_matches_plain_layer_by_layer(bias):
    """Each layer alone (as a one-layer decoder) on the same inputs, at the
    model's width: the card's order against fused_decoder_stack_plain."""
    rng = np.random.default_rng(21)
    c, heads, ff, nf = 256, 8, 384, 128
    tree = decoder_tree(rng, c, heads, ff, 3, bias=bias)
    args = _args(decoder_inputs(rng, 2, 100, 24, c), bias)
    kw = dict(num_heads=heads, num_feats=nf)
    for i in range(3):
        sub = {"ref_point_head": tree["ref_point_head"], "norm": tree["norm"],
               "layer0": tree[f"layer{i}"],
               "kpt_branch0": tree[f"kpt_branch{i}"]}
        dec = decoder(sub, c, heads, ff, 1, nf, bias)
        o, p = stack_tiled(*args, dec, **kw)
        ro, rp = tdec.fused_decoder_stack_plain(*args, dec, **kw)
        assert o.shape == (1, 2, 100, 2)
        _close(torch.cat([o, p]), torch.cat([ro, rp]), STACK_LAYER_MAX,
               STACK_LAYER_MEAN)


def test_stack_emulation_matches_jax_kernel_layer_by_layer():
    """At a small width against the Pallas stack in interpret mode, one
    layer at a time, to the 1e-4 of tests/test_torch_variant_ops.py."""
    rng = np.random.default_rng(22)
    c, heads, ff, nf = 64, 2, 128, 32       # the GCN width in 64-wide chunks
    tree = decoder_tree(rng, c, heads, ff, 2)
    inp = decoder_inputs(rng, 3, 12, 16, c)
    for i in range(2):
        lp = ({"dec": tree[f"layer{i}"], "kpt": tree[f"kpt_branch{i}"],
               "bias_mlp": tree[f"layer{i}"]["bias_mlp"]},)
        jo, jp = jdec.fused_decoder_stack(
            jnp.asarray(inp["x"]).astype(jnp.bfloat16),
            *(jnp.asarray(inp[k]) for k in ("coords", "img", "ipos", "valid",
                                             "hops", "adj")),
            lp, tree["ref_point_head"], tree["norm"], num_heads=heads,
            num_feats=nf, eps=1e-5, interpret=True)
        sub = {"ref_point_head": tree["ref_point_head"], "norm": tree["norm"],
               "layer0": tree[f"layer{i}"],
               "kpt_branch0": tree[f"kpt_branch{i}"]}
        o, p = stack_tiled(*_args(inp), decoder(sub, c, heads, ff, 1, nf),
                           num_heads=heads, num_feats=nf)
        for t, j in ((o, jo), (p, jp)):
            d = np.abs(t.numpy() - np.asarray(j, np.float32))
            assert d.max() <= 1e-4, (i, d.max())


def test_stack_weights_hold_only_what_the_stack_adds():
    """The layers' own weights come from their modules' cache
    (ops/fused_decoder.py _prepare); the stack keeps kpt_branch, the bias
    MLP, ref_point_head, the final norm and the stacked cross k / v."""
    rng = np.random.default_rng(23)
    dec = decoder(decoder_tree(rng, 64, 2, 96, 2), 64, 2, 96, 2, 32)
    w = tdec._build_stack_weights(dec, 32, True)
    assert [set(lw) for lw in w["layers"]] == [
        {"kpt", "kow", "kob", "hop_mlp"}] * 2
    assert w["wck_img"].shape == (2 * 128, 64)
    assert w["wcv"].shape == (2 * 128, 64)
    w1, b1, w2, b2 = w["layers"][1]["hop_mlp"]
    assert w1.shape == (5, 6) and w2.shape == (6, 2)
    assert all(t.dtype == torch.float32 and t.is_contiguous()
               for t in (w1, b1, w2, b2))
    assert set(tdec._build_stack_weights(dec, 32, False)["layers"][0]) == {
        "kpt", "kow", "kob"}


def test_stack_kernels_refuse_cpu_operands_and_count_nothing():
    n0 = dict(K.launches)
    c = 256
    x, ct = torch.zeros(10, c, dtype=torch.bfloat16), torch.zeros(10, 2)
    vec = (torch.zeros(c), torch.zeros(c))
    kpt = [(torch.zeros(c, c, dtype=torch.bfloat16), torch.zeros(c))] * 3
    with pytest.raises(ValueError):
        K.kpt_head(x, ct, vec, kpt, torch.zeros(2, c, dtype=torch.bfloat16),
                   torch.zeros(2), torch.zeros(10, 2), torch.zeros(10, 2),
                   eps=1e-5)
    mlp = (torch.zeros(5, 12), torch.zeros(12), torch.zeros(12, 8),
           torch.zeros(8))
    with pytest.raises(ValueError):
        K.bias_attention(torch.zeros(2, 10, 3 * c, dtype=torch.bfloat16),
                         None, torch.zeros(2, 10, 10, 5,
                                           dtype=torch.bfloat16),
                         mlp, num_heads=8)
    assert K.launches == n0


def test_cpu_stack_takes_the_plain_version():
    """On CPU tensors the op is its plain version and counts no launch."""
    rng = np.random.default_rng(24)
    dec = decoder(decoder_tree(rng, 64, 2, 96, 1), 64, 2, 96, 1, 32)
    args = _args(decoder_inputs(rng, 2, 12, 16, 64))
    n0, k0 = tdec.stack_launches, dict(K.launches)
    with torch.no_grad():
        got = tdec.fused_decoder_stack(*args, dec, num_heads=2, num_feats=32)
        ref = tdec.fused_decoder_stack_plain(*args, dec, num_heads=2,
                                             num_feats=32)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert tdec.stack_launches == n0 and K.launches == k0
