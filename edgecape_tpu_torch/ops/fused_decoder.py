"""One graph-decoder layer, and the whole decoder with its glue, as
chains of hand-written CUDA launches.

Replaces the TPU kernel `edgecape_tpu/ops/fused_decoder.py:
fused_decoder_layer` (`_kernel`), eval mode:
(1) keypoint self-attention with the key mask and the additive Markov
    bias [B, H, K, K], then LN1;
(2) cross-attention with q = [x; qpos] and k = [img; img_pos] at 2C,
    v = img, out_proj (2C, rounded to bf16) and the choker 2C -> C, then
    LN2;
(3) GCN: a linear to [K, 2, F] contracted with adj [B, 2, K, K] (both
    slices summed in fp32), ReLU, ffn2, then LN3.
Rounding points follow the TPU kernel: bf16 matmul operands with fp32
accumulation, fp32 LN statistics and softmax, bf16 q/k/v and attention
outputs, the adjacency rounded to bf16 for its contraction.

On the H100 a layer is eight launches: the self-attention's q, k, v
GEMM and attention (the Markov bias read), dec_post_self_kernel
(ops/kernels.py dec_post_self: out projection, residual and LN1, written
in fp32, and the cross-attention's query from [x1; qpos] as one
accumulation over both halves of its weight, so the concatenation is
never formed), the img_pos half of the key projection once per call
([HW, 2C], added in the key GEMM's epilogue), the key and value GEMMs
over the image tokens, the cross-attention, and dec_post_cross_kernel
(ops/kernels.py dec_post_cross), which runs the rest for one batch row
of K <= 128 keypoints a tile: out_proj in 64-column pieces each fed to
the choker at once, LN2, then per chunk of 64 GCN features both slices'
linear, the adjacency contraction on tensor cores with the adjacency in
shared memory (rows and columns past K zero), ReLU and ffn2, then LN3.
Its adjacency rows of K bf16 values (200 bytes at K = 100) are no TMA
box, so the threads copy them. Above 128 keypoints a batch row (COCO-
WholeBody's 133, Halpe's 136) the cross layer takes the two launches of
the other widths (below), dec_post_gcn_wide_kernel walking ceil(K / 64)
boxes of keys. The weights are made once per layer module and kept until
a parameter changes.

`fused_decoder_stack` replaces the TPU kernel `fused_decoder_stack`
(`_stack_kernel` through `_stack_chunk`) of the same file: all decoder
layers plus what the layer chain leaves to the framework between them.
On the H100 a call is 3 + 9 L launches: the cross-attention key and value
projections of all L layers as one GEMM each over [B HW, C] x [C, L 2C]
(the image tokens do not change across layers) and the img_pos half of
the keys once; then per layer
* the sine embedding of the current points (sine_feats_kernel writes
  [sin_y | cos_y | sin_x | cos_x] bf16 features; `permute_fc1` folds the
  embedding's sin / cos interleave into ref_point_head's first weight)
  and ref_point_head as two GEMMs with the GELU epilogue: qpos;
* the self-attention's q, k, v GEMM;
* the self-attention with the Markov bias (ops/kernels.py
  bias_attention): the bias MLP (n_hop -> hid -> H, ReLU) over the bf16
  hop stack is formed in the kernel once per (query, key) for all heads,
  into shared memory, so the [B, H, K, K] fp32 bias (163 MB a layer at 510
  rows, K = 100) is never in device memory and the hop stack is read once;
* dec_post_self_kernel and, after the cross-attention on the layer's
  slice of the stacked keys and values, dec_post_cross_kernel: the layer
  body of fused_decoder_layer above, on the layer module's own prepared
  weights; the layer's output is bf16;
* the keypoint head (ops/kernels.py kpt_head): the final norm and both
  kpt_branch evaluations (trajectory delta from the raw tokens,
  head-recompute delta from the final-normed tokens) and the fp32
  sigmoid(inverse_sigmoid(ct) + delta) of the layer's `points` and
  `outputs`, one kernel; the next layer reads its coordinates from
  `points`.
No PyTorch op runs between the launches. The rounding points are the TPU
kernel's: bf16 hop stack and adjacency, bf16 ref_point_head / kpt_branch
weights and activations, fp32 coordinates; its polynomial erf is the
exact `erff` in the ref_point_head GEMM and the same polynomial in the
keypoint head (the two differ by less than 1.5e-7); dec_post_cross adds
ffn2 onto the LN2 output it is added to (ops/kernels.py dec_post_cross).
The kernels of the layer body and the keypoint head are written for the
model's width C = 256 and the bias attention for 8 heads of 32; every
other width up to 512 channels, 1..16 heads of up to 128, takes their
companions (ops/kernels.py post_plan, kpt_head_plan, bias_attention_plan
choose): dec_post_self_wide_kernel, and for dec_post_cross_kernel's work
two launches, dec_post_cross_wide_kernel and dec_post_gcn_wide_kernel
(csrc/dec_self_wide.cu, csrc/dec_wide.cu: persistent 64-row tiles,
weights by TMA into wgmma), kpt_head_wide_kernel (csrc/kpt_wide.cu, the
same shape: the raw and normed rows stacked so that every weight box
serves both) and bias_attn_wide_kernel (csrc/head_wide.cu), so a
layer is 9 launches and a stack call 3 + 10 L. Above 128 keypoints, at
every width, the bias attention is bias_attn_long_kernel
(csrc/bias_long.cu: the keys streamed in tiles, the tile's bias formed
once for all heads, the two-pass softmax with the finished scores kept in
a scratch buffer) and the cross layer the wide pair, so a layer is 9
launches and a stack call 3 + 10 L there too.

Above 512 channels (the heads of ViT-B/14's 768 and ViT-L/14's 1024
widths), where a 64-row tile's fp32 rows fill an SM's registers and one
bf16 copy of it half its shared memory, the post-attention work and the
keypoint head take the split route (ops/kernels.py post_plan,
kpt_head_plan): each step of the plain version a launch of the port's own
kernels, the activations between them in device memory. The self half
is the out projection (a GEMM adding bias and xb), LN1 (layernorm_kernel,
fp32 and bf16(x1) into the first half of qin = [bf16(x1) | qpos]) and the
query as one product over qin; the cross half the out projection, the
choker adding x1, LN2, the GCN conv, the adjacency contraction as two
batched GEMMs per batch row (adj0 . y0 in fp32, then adj1 . y1 plus it
with the ReLU, the bf16 adjacency's rows at a 16-byte stride:
kernels.gcn_adjacency), ffn2 adding x2, LN3; the keypoint head the final
norm into the second half of kin = [x; LN(x)], the three kpt_branch
layers as GEMMs with the GELU epilogue over both halves at once, and
kpt_coord_kernel (csrc/kpt_coord.cu: the N = 2 delta head on the CUDA
cores and the sigmoid update). A layer is 17 launches and a stack call
3 + 22 L; the stack writes qpos and each layer's output into qin and kin
in place and lays the adjacency out once.

The stack's own weights (the permuted fc1, the stacked cross-attention
weights, kpt_branch, the bias MLPs) are prepared once per decoder module
and the layers' once per layer module, each kept until a parameter
changes.

The wrappers run the kernels for a CUDA tensor and the plain PyTorch
version for a CPU tensor; `launches` counts kernel runs of the layer op
and `stack_launches` those of the stack op.
"""

from __future__ import annotations

import torch

from . import plain
from .pos_enc import inverse_sigmoid

launches = 0
stack_launches = 0


def post_self_plain(att, xb, layer, eps: float = 1e-5):
    """The plain formulas after the self-attention: x1 = LN1(xb +
    out_proj(att)) in fp32. att is the attention's output [..., C], xb
    the layer's input rounded to bf16."""
    op = layer.self_attn.out_proj
    return plain.layer_norm(
        xb.to(torch.float32) + plain.linear(att, op.weight, op.bias),
        layer.norm1.weight, layer.norm1.bias, eps)


def cross_query_plain(x1, query_pos, layer):
    """The cross-attention's query from [x1; query_pos], fp32."""
    ca = layer.cross_attn
    return plain.linear(torch.cat([x1, query_pos.to(torch.float32)], dim=-1),
                        ca.q_proj.weight, ca.q_proj.bias)


def post_cross_plain(att2, x1, adj, layer, eps: float = 1e-5):
    """The plain formulas after the cross-attention: att2 [B, K, 2C] its
    output, x1 [B, K, C] the LN1 output, adj [B, 2, K, K]; out_proj
    (rounded to bf16), the choker and LN2, then the GCN (both adjacency
    slices summed in fp32), ReLU, ffn2 and LN3. Returns [B, K, C] fp32."""
    op = layer.cross_attn.out_proj
    o2 = plain.bf16(plain.linear(att2, op.weight, op.bias))
    x2 = plain.layer_norm(
        x1 + plain.linear(o2, layer.choker.weight, layer.choker.bias),
        layer.norm2.weight, layer.norm2.bias, eps)
    y = plain.bf16(plain.linear(x2, layer.gcn.conv.weight,
                                layer.gcn.conv.bias))
    f_dim = y.shape[-1] // 2
    a = plain.bf16(adj)
    m = (torch.matmul(a[:, 0], y[..., :f_dim])
         + torch.matmul(a[:, 1], y[..., f_dim:]))
    f = plain.linear(torch.relu(m), layer.ffn2.weight, layer.ffn2.bias)
    return plain.layer_norm(x2 + f, layer.norm3.weight, layer.norm3.bias,
                            eps)


def fused_decoder_layer_plain(x, query_pos, img_tokens, img_pos, kp_valid,
                              bias, adj, layer, *, num_heads: int,
                              eps: float = 1e-5):
    """Plain PyTorch version. x/query_pos [B, K, C]; img_tokens [B, HW, C];
    img_pos [HW, C]; kp_valid [B, K] bool; bias [B, H, K, K]; adj
    [B, 2, K, K]; layer: a models.transformer.DecoderLayer. Returns
    [B, K, C] in x.dtype."""
    sa, ca = layer.self_attn, layer.cross_attn
    c = x.shape[-1]
    d, d2 = c // num_heads, 2 * c // num_heads
    xb = plain.bf16(x)
    q = plain.linear(xb, sa.q_proj.weight, sa.q_proj.bias)
    k = plain.linear(xb, sa.k_proj.weight, sa.k_proj.bias)
    v = plain.linear(xb, sa.v_proj.weight, sa.v_proj.bias)
    att = plain.attention(q, k, v, num_heads=num_heads, scale=d ** -0.5,
                          kb=plain.key_bias(kp_valid), bias=bias)
    x1 = post_self_plain(att, xb, layer, eps)

    img = plain.bf16(img_tokens)
    ipos = plain.bf16(img_pos)[None].expand(img.shape[0], -1, -1)
    kc = torch.cat([img, ipos], dim=-1)
    q2 = cross_query_plain(x1, query_pos, layer)
    k2 = plain.linear(kc, ca.k_proj.weight, ca.k_proj.bias)
    v2 = plain.linear(img, ca.v_proj.weight, ca.v_proj.bias)
    att2 = plain.attention(q2, k2, v2, num_heads=num_heads, scale=d2 ** -0.5)
    return post_cross_plain(att2, x1, adj, layer, eps).to(x.dtype)


def _prepare(layer) -> dict:
    """The layer's weights as the kernels take them, in the layout of
    ops/kernels.py post_plan: the GCN width padded to its chunks and, at a
    width other than 256 up to 512, the post-attention kernels' weights
    padded to c_pad channels and 2C to c2_pad (zero rows and columns,
    pad_gcn / pad_cols); the GEMMs' weights as they are (on the split
    route above 512 channels all of them, with the cross-attention's
    whole query weight `wcq`)."""
    from . import kernels as K
    sa, ca = layer.self_attn, layer.cross_attn
    w16 = lambda w: w.detach().to(torch.bfloat16).contiguous()  # noqa: E731
    v32 = lambda v: v.detach().to(torch.float32).contiguous()  # noqa: E731
    c = layer.norm1.weight.shape[0]
    f = layer.ffn2.in_features
    plan = K.post_plan(1, c, f, chunk=K.DEC_CHUNK)
    cp = plan.get("c_pad", c)
    c2p = plan.get("c2_pad", 2 * c)
    wg, bg, wf = K.pad_gcn(layer.gcn.conv.weight, layer.gcn.conv.bias,
                           layer.ffn2.weight, plan.get("f_pad", f), cp)
    pad = K.pad_cols
    wq, wk = ca.q_proj.weight, ca.k_proj.weight
    # the split route's query product takes [bf16(x1) | qpos] whole
    split = {"wcq": w16(wq)} if plan.get("split") else {}
    return {**split,
        "wqkv": w16(torch.cat([sa.q_proj.weight, sa.k_proj.weight,
                               sa.v_proj.weight])),
        "bqkv": v32(torch.cat([sa.q_proj.bias, sa.k_proj.bias,
                               sa.v_proj.bias])),
        "wso": w16(pad(sa.out_proj.weight, cp, cp)),
        "bso": v32(sa.out_proj.bias),
        "g1": v32(layer.norm1.weight), "be1": v32(layer.norm1.bias),
        "wcq_x": w16(pad(wq[:, :c], c2p, cp)),
        "wcq_p": w16(pad(wq[:, c:], c2p, cp)),
        "bcq": v32(ca.q_proj.bias),
        "wck_img": w16(wk[:, :c]), "wck_pos": w16(wk[:, c:]),
        "bck": v32(ca.k_proj.bias),
        "wcv": w16(ca.v_proj.weight), "bcv": v32(ca.v_proj.bias),
        "wco": w16(pad(ca.out_proj.weight, c2p, c2p)),
        "bco": v32(ca.out_proj.bias),
        "wch": w16(pad(layer.choker.weight, cp, c2p)),
        "bch": v32(layer.choker.bias),
        "g2": v32(layer.norm2.weight), "be2": v32(layer.norm2.bias),
        "wg": w16(wg), "bg": v32(bg), "wf": w16(wf),
        "bf": v32(layer.ffn2.bias),
        "g3": v32(layer.norm3.weight), "be3": v32(layer.norm3.bias)}


def cross_weights(layer, w: dict, keypoints: int) -> dict:
    """The layer's weights as dec_post_cross takes them at `keypoints` a
    batch row: w (from _prepare) itself, except at POST_C channels above
    POST_TILE keypoints, where the wide pair takes the cross layer and
    reads the GCN in whole ENC_WIDE_CHUNK chunks: there, where the GCN
    width is no multiple of them, w with wg, bg, wf padded to the wide
    plan's f_pad, made once and kept like w (module_weights)."""
    from . import kernels as K
    c, f = layer.norm1.weight.shape[0], layer.ffn2.in_features
    f_pad = K.post_plan(keypoints, c, f, chunk=K.DEC_CHUNK,
                        keypoints=keypoints).get("f_pad", f)
    if w["wf"].shape[1] == f_pad:
        return w

    def build(m):
        wg, bg, wf = K.pad_gcn(m.gcn.conv.weight, m.gcn.conv.bias,
                               m.ffn2.weight, f_pad, w["wf"].shape[0])
        return dict(w, wg=wg.detach().to(torch.bfloat16).contiguous(),
                    bg=bg.detach().to(torch.float32).contiguous(),
                    wf=wf.detach().to(torch.bfloat16).contiguous())
    return K.module_weights(layer, "_kernel_weights_wide_gcn", build, f_pad)


def _fused_decoder_layer_cuda(x, query_pos, img_tokens, img_pos, kp_valid,
                              bias, adj, layer, *, num_heads, eps):
    from . import kernels as K
    bf = torch.bfloat16
    w = K.module_weights(layer, "_kernel_weights", _prepare)
    b, k, c = x.shape
    r = b * k
    d, d2 = c // num_heads, 2 * c // num_heads

    # (1) biased, key-masked self-attention; out_proj, LN1 and the
    # cross-attention's query in one kernel
    xb = x.to(bf).reshape(r, c).contiguous()
    qkv = K.gemm(xb, w["wqkv"], b_nk=True, bias=w["bqkv"]).view(b, k, 3 * c)
    att = K.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                      num_heads=num_heads, scale=d ** -0.5,
                      key_valid=kp_valid, bias=bias)
    qp = query_pos.to(bf).reshape(r, c).contiguous()
    x1, q2 = K.dec_post_self(att.view(r, c), xb, qp, w, eps=eps)

    # (2) concat-position cross-attention: keys [img; img_pos] . Wk^T as
    # the image half per row plus the position half once per call
    img = img_tokens.to(bf)
    if img.stride(-1) != 1:
        img = img.contiguous()
    ipos = img_pos.to(bf).contiguous()
    kpos = K.gemm(ipos, w["wck_pos"], b_nk=True, bias=w["bck"],
                  out_dtype=torch.float32)                     # [HW, 2C]
    k2 = K.gemm(img, w["wck_img"], b_nk=True, pre=kpos)        # [B, HW, 2C]
    v2 = K.gemm(img, w["wcv"], b_nk=True, bias=w["bcv"])       # [B, HW, 2C]
    att2 = K.attention(q2.view(b, k, 2 * c), k2, v2, num_heads=num_heads,
                       scale=d2 ** -0.5)

    # (3) out_proj, choker, LN2, GCN, ffn2, LN3 in one kernel (two above
    # POST_TILE keypoints and away from POST_C channels)
    return K.dec_post_cross(att2, x1, adj, cross_weights(layer, w, k),
                            eps=eps, out_dtype=x.dtype).view(b, k, c)


def fused_decoder_layer(x, query_pos, img_tokens, img_pos, kp_valid, bias,
                        adj, layer, *, num_heads: int, eps: float = 1e-5):
    """One graph-decoder layer (see the module docstring)."""
    global launches
    if not x.is_cuda:
        return fused_decoder_layer_plain(
            x, query_pos, img_tokens, img_pos, kp_valid, bias, adj, layer,
            num_heads=num_heads, eps=eps)
    out = _fused_decoder_layer_cuda(
        x, query_pos, img_tokens, img_pos, kp_valid, bias, adj, layer,
        num_heads=num_heads, eps=eps)
    launches += 1
    return out


# ------------------------------------------------------------------ stack
def permute_fc1(fc1_weight: torch.Tensor, num_feats: int) -> torch.Tensor:
    """Fold the sine embedding's sin / cos interleave into
    ref_point_head.fc1. fc1_weight: the torch Linear weight [C, 2F], whose
    column j multiplies emb[j] = sin(ang[j]) for even j, cos(ang[j]) for
    odd j, y first then x (pos_enc.sine_coords). The stack feeds
    [sin_y | cos_y | sin_x | cos_x], each F wide, so the result [C, 4F]
    holds each column at its (axis, sin / cos, frequency) slot and zeros
    elsewhere."""
    f = num_feats
    ev = torch.arange(0, f, 2)
    od = torch.arange(1, f, 2)
    out = fc1_weight.new_zeros((fc1_weight.shape[0], 4 * f))
    out[:, ev] = fc1_weight[:, ev]                      # sin_y, even
    out[:, f + od] = fc1_weight[:, od]                  # cos_y, odd
    out[:, 2 * f + ev] = fc1_weight[:, f + ev]          # sin_x
    out[:, 3 * f + od] = fc1_weight[:, f + od]          # cos_x
    return out


def _rdt(num_feats: int, device=None) -> torch.Tensor:
    """Reciprocal temperatures of the sine embedding, [F] fp32."""
    t = torch.tensor([10000.0 ** (2.0 * (i // 2) / num_feats)
                      for i in range(num_feats)], dtype=torch.float32)
    return (1.0 / t).to(device)


def _has_bias(decoder, hop_stack) -> bool:
    return bool(decoder.attn_bias) and hop_stack is not None


@torch.no_grad()
def fused_decoder_stack_plain(x, initial_coords, img_tokens, img_pos,
                              kp_valid, hop_stack, adj, decoder, *,
                              num_heads: int, num_feats: int,
                              eps: float = 1e-5):
    """Plain PyTorch version of the stack, with the TPU kernel's rounding
    points; like the kernels it takes no gradient. Arguments as
    fused_decoder_stack."""
    f32 = torch.float32
    b = x.shape[0]
    rph, norm = decoder.ref_point_head, decoder.norm
    fc1p = permute_fc1(rph.fc1.weight.to(f32), num_feats)
    rdt = _rdt(num_feats, x.device)
    hops = plain.bf16(hop_stack) if _has_bias(decoder, hop_stack) else None
    xb = x.to(torch.bfloat16)
    ct = initial_coords.to(f32)
    outs, pts = [], []
    for layer, branch in zip(decoder.layers, decoder.kpt_branches):
        ang_x = (ct[..., 0:1] * 6.283185307179586) * rdt
        ang_y = (ct[..., 1:2] * 6.283185307179586) * rdt
        feats = torch.cat([torch.sin(ang_y), torch.cos(ang_y),
                           torch.sin(ang_x), torch.cos(ang_x)], dim=-1)
        h = plain.gelu(plain.linear(feats, fc1p, rph.fc1.bias))
        qpos = plain.bf16(plain.linear(h, rph.fc2.weight, rph.fc2.bias))
        bias = None
        if hops is not None:
            mlp = layer.bias_mlp
            hid = torch.relu(hops @ mlp.fc1.weight.to(f32).t()
                             + mlp.fc1.bias.to(f32))
            bias = (hid @ mlp.fc2.weight.to(f32).t()
                    + mlp.fc2.bias.to(f32)).permute(0, 3, 1, 2)
        xb = fused_decoder_layer_plain(
            xb, qpos, img_tokens, img_pos, kp_valid, bias, adj, layer,
            num_heads=num_heads, eps=eps)                     # bf16
        n_bf = plain.layer_norm(xb, norm.weight, norm.bias, eps)
        kh = torch.cat([xb.to(f32), n_bf], dim=0)            # [2B, K, C]
        for fc in (branch.fc0, branch.fc1, branch.fc2):
            kh = plain.gelu(plain.linear(kh, fc.weight, fc.bias))
        dd = plain.linear(kh, branch.out.weight, branch.out.bias)
        inv = inverse_sigmoid(ct)
        ct_new = torch.sigmoid(inv + dd[:b])
        outs.append(torch.sigmoid(inv + dd[b:]))
        pts.append(ct_new)
        ct = ct_new
    return torch.stack(outs, dim=0), torch.stack(pts, dim=0)


@torch.no_grad()
def bias_attention_plain(qkv, key_valid, hops, hop_mlp, *,
                         num_heads: int) -> torch.Tensor:
    """Plain version of ops/kernels.py bias_attention: qkv [B, K, 3C];
    key_valid [B, K] bool; hops [B, K, K, n_hop]; hop_mlp (w1 [n_hop,
    hid], b1, w2 [hid, H], b2). Returns [B, K, C] fp32 holding bf16
    values."""
    c = qkv.shape[-1] // 3
    w1, b1, w2, b2 = (t.to(torch.float32) for t in hop_mlp)
    bias = (torch.relu(plain.bf16(hops) @ w1 + b1) @ w2 + b2).permute(
        0, 3, 1, 2)
    return plain.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                           num_heads=num_heads, scale=(c // num_heads) ** -0.5,
                           kb=plain.key_bias(key_valid), bias=bias)


@torch.no_grad()
def kpt_head_plain(x, ct, fn, kpt, kow, kob, *, eps: float,
                   sums: torch.dtype = torch.float32):
    """Plain version of ops/kernels.py kpt_head, the TPU kernel's final
    norm, dual kpt_branch and coordinate update: x [R, C] (bf16 values);
    ct [R, 2]; fn (gamma, beta); kpt three (weight, bias), the weights
    [C, C] or, as the wide kernel takes them, padded with zero rows and
    columns (the hidden then carries zero columns past C); kow, kob the
    delta head. The products of bf16 values are summed in `sums`: float32
    (the kernels' accumulation) or float64 (the same function summed all
    but exactly: the yardstick of a sum's own rounding). Returns (pts,
    outs) fp32 [R, 2]."""
    def linear(h, w, b):
        y = torch.matmul(plain.bf16(h).to(sums), plain.bf16(w).to(sums).t())
        return y.to(torch.float32) + b.to(torch.float32)

    r, c = x.shape
    kh = torch.cat([x.to(torch.float32), plain.layer_norm(x, *fn, eps)])
    for w, b in kpt:
        kh = torch.nn.functional.pad(kh, (0, w.shape[1] - kh.shape[1]))
        b = torch.nn.functional.pad(b.to(torch.float32),
                                    (0, w.shape[0] - b.shape[0]))
        kh = plain.gelu(linear(kh, w, b))
    dd = linear(kh[:, :c], kow, kob)
    inv = inverse_sigmoid(ct.to(torch.float32))
    return torch.sigmoid(inv + dd[:r]), torch.sigmoid(inv + dd[r:])


@torch.no_grad()
def kpt_coord_plain(h, ct, kow, kob):
    """Plain version of ops/kernels.py kpt_coord: h [2R, C] the stacked
    rows (bf16 values: the raw pass, then the normed one); ct [R, 2];
    kow, kob the delta head. Returns (pts, outs) fp32 [R, 2]."""
    r = h.shape[0] // 2
    dd = plain.linear(h, kow, kob)
    inv = inverse_sigmoid(ct.to(torch.float32))
    return torch.sigmoid(inv + dd[:r]), torch.sigmoid(inv + dd[r:])


def _stack_weights(decoder, num_feats: int, has_bias: bool) -> dict:
    """What the stack adds to its layers' weights, in the form its
    launches take, built once per decoder module and kept until a
    parameter is replaced or written."""
    from .kernels import module_weights
    return module_weights(
        decoder, "_stack_cache",
        lambda m: _build_stack_weights(m, num_feats, has_bias),
        num_feats, has_bias)


def _build_stack_weights(decoder, num_feats: int, has_bias: bool) -> dict:
    bf, f32 = torch.bfloat16, torch.float32
    w16 = lambda w: w.detach().to(bf).contiguous()  # noqa: E731
    v32 = lambda v: v.detach().to(f32).contiguous()  # noqa: E731
    from .kernels import kpt_head_plan, pad_cols
    rph, norm = decoder.ref_point_head, decoder.norm
    c = norm.weight.shape[0]
    cp = kpt_head_plan(1, c).get("c_pad", c)
    layers = []
    for layer, branch in zip(decoder.layers, decoder.kpt_branches):
        w = {"kpt": [(w16(pad_cols(fc.weight, cp, cp)), v32(fc.bias))
                     for fc in (branch.fc0, branch.fc1, branch.fc2)],
             "kow": w16(branch.out.weight), "kob": v32(branch.out.bias)}
        if has_bias:
            mlp = layer.bias_mlp
            w["hop_mlp"] = (v32(mlp.fc1.weight.t()), v32(mlp.fc1.bias),
                            v32(mlp.fc2.weight.t()), v32(mlp.fc2.bias))
        layers.append(w)
    cas = [layer.cross_attn for layer in decoder.layers]
    wk = [w16(ca.k_proj.weight) for ca in cas]                 # [2C, 2C]
    return {
        "layers": layers,
        "rdt": _rdt(num_feats, norm.weight.device),
        "fc1p": w16(permute_fc1(rph.fc1.weight.detach().to(f32), num_feats)),
        "rb1": v32(rph.fc1.bias), "fc2": w16(rph.fc2.weight),
        "rb2": v32(rph.fc2.bias),
        "fn": (v32(norm.weight), v32(norm.bias)),
        # cross-attention keys and values of every layer in one GEMM each
        "wck_img": torch.cat([w[:, :c] for w in wk]).contiguous(),
        "wck_pos": torch.cat([w[:, c:] for w in wk]).contiguous(),
        "bck": v32(torch.cat([ca.k_proj.bias for ca in cas])),
        "wcv": w16(torch.cat([ca.v_proj.weight for ca in cas])),
        "bcv": v32(torch.cat([ca.v_proj.bias for ca in cas])),
    }


def _fused_decoder_stack_cuda(x, initial_coords, img_tokens, img_pos,
                              kp_valid, hop_stack, adj, decoder, *,
                              num_heads, num_feats, eps):
    from . import kernels as K
    bf, f32 = torch.bfloat16, torch.float32
    b, k, c = x.shape
    hw = img_tokens.shape[1]
    r = b * k
    d, d2 = c // num_heads, 2 * c // num_heads
    c2 = 2 * c
    has_bias = _has_bias(decoder, hop_stack)
    w = _stack_weights(decoder, num_feats, has_bias)
    n_layers = len(w["layers"])

    # inputs in the kernels' types and layouts, once for all layers
    xb = x.to(bf).reshape(r, c).contiguous()
    ct = initial_coords.to(f32).reshape(r, 2).contiguous()
    img = img_tokens.to(bf).contiguous()
    ipos = img_pos.to(bf).contiguous()
    hops = hop_stack.to(bf).contiguous() if has_bias else None
    kpos = K.gemm(ipos, w["wck_pos"], b_nk=True, bias=w["bck"],
                  out_dtype=f32)                             # [HW, L 2C]
    k_all = K.gemm(img, w["wck_img"], b_nk=True, pre=kpos)   # [B, HW, L 2C]
    v_all = K.gemm(img.view(b * hw, c), w["wcv"], b_nk=True,
                   bias=w["bcv"]).view(b, hw, n_layers * c2)

    outs = torch.empty((n_layers, b, k, 2), dtype=f32, device=x.device)
    pts = torch.empty((n_layers, b, k, 2), dtype=f32, device=x.device)
    # the split route (above 512 channels): the adjacency laid out once for
    # all layers; qpos written into the second half of the query product's
    # input qin = [bf16(x1) | qpos], each layer's output into the first
    # half of the keypoint head's kin = [x; LN(x)]
    qin = kin = None
    if K.post_plan(1, c, K.ENC_CHUNK).get("split"):
        adj = K.gcn_adjacency(adj)
        qin = torch.empty((r, c2), dtype=bf, device=x.device)
        kin = torch.empty((2 * r, c), dtype=bf, device=x.device)
    for li, (layer, sw) in enumerate(zip(decoder.layers, w["layers"])):
        lw = K.module_weights(layer, "_kernel_weights", _prepare)
        # query positions from the current points
        feats = K.sine_feats(ct, w["rdt"])
        h = K.gemm(feats, w["fc1p"], b_nk=True, bias=w["rb1"],
                   act=K.ACT_GELU)
        qpos = K.gemm(h, w["fc2"], b_nk=True, bias=w["rb2"],
                      out=None if qin is None else qin[:, c:])

        # (1) self-attention, the Markov bias formed once for all heads;
        # out_proj, LN1 and the cross-attention's query in one kernel
        qkv = K.gemm(xb, lw["wqkv"], b_nk=True,
                     bias=lw["bqkv"]).view(b, k, 3 * c)
        if has_bias:
            att = K.bias_attention(qkv, kp_valid, hops, sw["hop_mlp"],
                                   num_heads=num_heads)
        else:
            att = K.attention(qkv[..., :c], qkv[..., c:2 * c],
                              qkv[..., 2 * c:], num_heads=num_heads,
                              scale=d ** -0.5, key_valid=kp_valid)
        x1, q2 = K.dec_post_self(att.view(r, c), xb, qpos, lw, eps=eps,
                                 qin=qin)

        # (2) cross-attention on this layer's keys and values; out_proj,
        # choker, LN2, GCN, ffn2, LN3 in one kernel
        sl = slice(li * c2, (li + 1) * c2)
        att2 = K.attention(q2.view(b, k, c2), k_all[..., sl], v_all[..., sl],
                           num_heads=num_heads, scale=d2 ** -0.5)
        xb = K.dec_post_cross(att2, x1, adj, cross_weights(layer, lw, k),
                              eps=eps, out_dtype=bf,
                              out=None if kin is None else kin[:r])

        # (3) final norm, both kpt_branch passes, the coordinate update
        K.kpt_head(xb, ct, w["fn"], sw["kpt"], sw["kow"], sw["kob"],
                   pts[li].view(r, 2), outs[li].view(r, 2), eps=eps,
                   kin=kin)
        ct = pts[li].view(r, 2)
    return outs, pts


def fused_decoder_stack(x, initial_coords, img_tokens, img_pos, kp_valid,
                        hop_stack, adj, decoder, *, num_heads: int,
                        num_feats: int, eps: float = 1e-5):
    """The whole refinement decoder. x [B, K, C]; initial_coords
    [B, K, 2]; img_tokens [B, HW, C]; img_pos [HW, C]; kp_valid [B, K]
    bool; hop_stack [B, K, K, n_hop] or None; adj [B, 2, K, K]; decoder:
    a models.transformer.Decoder (its layers, kpt_branches,
    ref_point_head and norm; the bias MLPs are used when the decoder has
    them and a hop stack is given). Returns (outputs [L, B, K, 2]: the
    head-recompute predictions, points [L, B, K, 2]: the trajectory after
    each layer), both fp32."""
    global stack_launches
    if not x.is_cuda:
        return fused_decoder_stack_plain(
            x, initial_coords, img_tokens, img_pos, kp_valid, hop_stack,
            adj, decoder, num_heads=num_heads, num_feats=num_feats, eps=eps)
    out = _fused_decoder_stack_cuda(
        x, initial_coords, img_tokens, img_pos, kp_valid, hop_stack, adj,
        decoder, num_heads=num_heads, num_feats=num_feats, eps=eps)
    stack_launches += 1
    return out
