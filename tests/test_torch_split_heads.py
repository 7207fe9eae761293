"""Heads of more than 512 channels (ViT-B/14's 768 in 12 heads, ViT-L/14's
1024 in 16): the split route of ops/kernels.py, on the CPU.

Above WIDE_MAX_C channels a 64-row tile's fp32 rows fill an SM's registers,
so the post-attention work of the encoder and decoder layers and the
keypoint head run as chains of the port's own kernels (the GEMM with its
epilogue, layernorm_kernel, add_pos_kernel, kpt_coord_kernel), with the
plain versions' rounding points.

* Plans: post_plan and kpt_head_plan give split plans from 513 channels up
  at channels and hidden widths in multiples of 8 (split_refusal names
  the others), 512 stays on the wide kernels; width_misfits takes the stage-3 model at 768 / 12 over a 768-channel
  trunk and 1024 / 16 over a 1024-channel one; 1024 / 8 (a cross-attention
  head dim of 256) and 1088 / 17 with the Markov bias (17 bias heads) stay
  refused by name.
* The route itself, its Python as it runs on the card, with each kernel
  entry point (ops/kernels.py `_call`) replaced by a CPU stand-in that
  reads and writes the operands through the very pointers and strides
  the wrappers pass (`split_kernels`): the GEMM (fp32 products, its
  epilogue in the kernel's order; it refuses, as ec_gemm does, a TMA
  mainloop whose operands a tensor map cannot describe; the split route's
  products take the one that sums each 64-deep k tile apart, and gemm
  refuses it for such operands),
  layernorm_kernel
  and kpt_coord_kernel in their sum orders (`ln_rows_any`,
  `kpt_coord_rows`), add_pos_kernel; the attention kernels stand in at
  the Python level by their plain versions. The encoder stack, the
  decoder layer (K 12 and 133) and the decoder stack against the plain
  versions: the same rounding points, only the fp32 sums grouped
  otherwise, so fp32 noise except where it flips a bf16 rounding (ULP_MAX
  / NOISE_MEAN of tests/test_torch_fused_post.py; a stack layer
  STACK_LAYER_MAX / STACK_LAYER_MEAN), and the launches a call makes.
* The two sum orders the route adds (the LayerNorm looped over 64-column
  groups at any C, the delta head's lanes) emulated against their plain
  versions to fp32 noise.
* The port's plain versions of #3, #4 and #5 at 576 / 9 and 640 / 10 (FFN
  1.5 C, HW 16, 2 rows; K 12 and 133) against the JAX Pallas kernels in
  interpret mode, to the bounds of tests/test_torch_fused_post.py and
  tests/test_torch_kpts.py (BF16_MAX / BF16_MEAN a layer,
  STACK_LAYER_MAX / STACK_LAYER_MEAN a stack layer).
* The slice: the stage-3 model at 640 / 10 over the toy trunk of
  tests/test_torch_slice.py, JAX weights carried by
  convert.from_jax_params, the port's fp32 forward_cached against the JAX
  strict path to 1e-4 on normalised coordinates."""

import contextlib
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.api import PoseEstimator as JaxEstimator
from edgecape_tpu.models import dinov2 as jdinov2
from edgecape_tpu.ops import fused_decoder as jdec
from edgecape_tpu.ops import fused_encoder as jenc
from edgecape_tpu_torch.models.edgecape import HEAD_OPS, EdgeCape
from edgecape_tpu_torch.ops import fused_decoder as tdec
from edgecape_tpu_torch.ops import fused_encoder as tenc
from edgecape_tpu_torch.ops import kernel_config as KC
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain
from test_torch_decoder_stack import (STACK_LAYER_MAX, STACK_LAYER_MEAN,
                                      _args, decoder, decoder_inputs,
                                      decoder_tree)
from test_torch_fused_post import (BF16_MAX, BF16_MEAN, _close, _decoder,
                                   _decoder_inputs, _encoder, _encoder_args)
from test_torch_head_widths import _width_cfg
from test_torch_vit_mlp import _butterfly, _fma
from test_torch_slice import (COORD_TOL, SIZE, TRUNK, _cfg, _episodes,
                              _jax_estimator, _perturb, _torch_estimator)

# (d_model, nhead) of the module tests, FFN 1.5 C: head dims 64 / 128
SPLIT = [(576, 9), (640, 10)]
IEPS = 1e-3
T = torch.from_numpy


# ------------------------------------------------------------- plans
@pytest.mark.parametrize("c", [513, 640, 768, 1024])
def test_split_plans_above_512_channels(c):
    """From 513 channels the post-attention plans and the keypoint head's
    are split, with no padding of the weights, at channels and hidden
    widths in multiples of 8 (the slab GEMM's tensor maps); other widths
    there are refused by name (split_refusal). 512 channels stay on the
    wide kernels."""
    f = 3 * c // 2
    if c % 8:
        for plan in (lambda: K.post_plan(51000, c, f),
                     lambda: K.kpt_head_plan(51000, c),
                     lambda: K.post_plan(510 * 100, c, f, chunk=K.DEC_CHUNK,
                                         keypoints=100)):
            with pytest.raises(ValueError,
                               match=f"channels in multiples of 8, got {c}"):
                plan()
        c = -(-c // 8) * 8
        f = 2 * c
    assert K.split_refusal(c, f) is None
    assert K.post_plan(51000, c, f) == {"split": True}
    for k in (100, 133):
        assert K.post_plan(510 * k, c, f, chunk=K.DEC_CHUNK,
                           keypoints=k) == {"split": True}
    assert K.kpt_head_plan(51000, c) == {"split": True}
    for bad in (f + 4, 24):
        with pytest.raises(ValueError, match=f"hidden widths in multiples "
                                             f"of 8 from 32, got {bad}"):
            K.post_plan(51000, c, bad)
    assert K.post_plan(100, 512, 1024)["wide"]
    assert K.kpt_head_plan(100, 512)["wide"]
    with pytest.raises(ValueError, match="1 channel or more"):
        K.post_plan(100, 0, 64)
    with pytest.raises(ValueError, match="1 channel or more"):
        K.kpt_head_plan(100, 0)


@pytest.mark.parametrize("c,h,ffn,vit", [(768, 12, 1536, (768, 12)),
                                         (1024, 16, 2048, (1024, 16))],
                         ids=["768/12-vit-b", "1024/16-vit-l"])
def test_width_misfits_take_heads_as_wide_as_their_trunk(c, h, ffn, vit):
    """The stage-3 model with a head as wide as its DINOv2 trunk is taken
    by every fused op, at 224 px and at 133 keypoints: a build for the
    card passes its width check."""
    for kw in ({}, {"max_kpt": 133}):
        cfg = dataclasses.replace(_width_cfg(c, h, ffn, **kw),
                                  backbone_dim=vit[0])
        out = K.width_misfits(cfg, vit_dim=vit[0], vit_heads=vit[1])
        assert all(why is None for why in out.values()), out
        KC.require_widths(HEAD_OPS + ("fused_vit_block",), out, "cuda")


@pytest.mark.parametrize("c,h,ops,why", [
    (1024, 8, {"fused_decoder_layer", "fused_decoder_stack"},
     "head dims 1..128, got 256"),
    (1088, 17, {"fused_decoder_stack"},
     "the bias attention takes 1..16 heads of 1..128, got 17 of 64"),
    (580, 10, {"fused_encoder_stack", "fused_decoder_layer",
               "fused_decoder_stack"},
     "the split route takes channels in multiples of 8, got 580"),
], ids=["1024/8", "1088/17", "580/10"])
def test_what_stays_refused_past_512_is_named(c, h, ops, why):
    """1024 channels in 8 heads are refused by the cross-attention's head
    dim (2 C / H = 256), 1088 in 17 by the Markov bias's 17 heads, 580 in
    10 by the split route (the slab GEMM's tensor maps need row strides
    in multiples of 8); each by the ops whose plans refuse it, at build
    time for the card."""
    cfg = _width_cfg(c, h, 2 * c)
    out = K.width_misfits(cfg)
    assert {op for op, w in out.items() if w is not None} == ops, out
    assert all(why in out[op] for op in ops), out
    with pytest.raises(ValueError) as err:
        EdgeCape(cfg, use_flash=True, device="cuda")
    msg = str(err.value)
    assert all(f"{op} (" in msg for op in ops), msg
    assert ("channels" in msg) == ("channels" in why), msg
    with pytest.raises(ValueError, match="fused_decoder_stack"):
        KC.require_widths(("fused_decoder_stack",), out, "cuda")


# ------------------------------------------------------------- emulations
def _lanes(c):
    """The columns 64 k + 2 l + e of each lane l, for k ascending then e:
    [steps, 32] indices and their mask (< c)."""
    n = -(-c // 64)
    cols = torch.arange(64 * n).view(n, 32, 2).permute(0, 2, 1)
    cols = cols.reshape(2 * n, 32)
    return cols.clamp(max=c - 1), cols < c


def ln_rows_any(v, g, b, eps=1e-5):
    """layernorm_kernel's order at any C (csrc/kernels.cu): lane partial
    sums over its columns, the butterfly, the two-pass variance by fused
    multiply-adds, (v - mean) * inv * g + b: fp32 [R, C]."""
    v = v.float()
    cols, mask = _lanes(v.shape[1])
    s = torch.zeros(v.shape[0], 32)
    for i in range(cols.shape[0]):
        s = torch.where(mask[i], s + v[:, cols[i]], s)
    mean = (_butterfly(s) / v.shape[1])[:, None]
    q = torch.zeros(v.shape[0], 32)
    for i in range(cols.shape[0]):
        d = v[:, cols[i]] - mean
        q = torch.where(mask[i], _fma(d, d, q), q)
    inv = torch.rsqrt(_butterfly(q) / v.shape[1] + eps)[:, None]
    return _fma((v - mean) * inv, g.float(), b.float())


def kpt_coord_rows(h, ct, wo, bo, ieps=IEPS):
    """kpt_coord_kernel's order (csrc/kpt_coord.cu): a lane's products of
    its columns summed by fused multiply-adds (exact products of bf16
    values), the butterfly, + bo, the clipped log-odds and the sigmoid.
    Returns (pts, outs) fp32 [R, 2]."""
    h, wo = h.float(), wo.float()
    r = h.shape[0] // 2
    cols, mask = _lanes(h.shape[1])
    dd = []
    for o in range(2):
        s = torch.zeros(2 * r, 32)
        for i in range(cols.shape[0]):
            s = torch.where(mask[i], s + h[:, cols[i]] * wo[o, cols[i]], s)
        dd.append(_butterfly(s) + bo[o].float())
    dd = torch.stack(dd, dim=1)
    c = ct.float().clamp(0.0, 1.0)
    inv = torch.log(c.clamp(min=ieps) / (1.0 - c).clamp(min=ieps))
    return (1.0 / (1.0 + torch.exp(-(inv + dd[:r]))),
            1.0 / (1.0 + torch.exp(-(inv + dd[r:]))))


@pytest.mark.parametrize("c", [576, 600, 1024, 1536])
def test_looped_layernorm_emulation_matches_plain(c):
    """layernorm_kernel's order past 512 channels (the same three passes
    over 64-column groups, a group's tail masked where C is no multiple
    of 64) against the plain LayerNorm: fp32 noise."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(37, c, generator=g) * 3 + 1
    gamma = 1 + 0.1 * torch.randn(c, generator=g)
    beta = 0.1 * torch.randn(c, generator=g)
    d = (ln_rows_any(x, gamma, beta) - plain.layer_norm(x, gamma, beta,
                                                        1e-5)).abs()
    assert d.max().item() <= 2e-6, d.max().item()


@pytest.mark.parametrize("c", [577, 640, 1024])
def test_kpt_coord_emulation_matches_plain(c):
    """The delta head's lane order against kpt_coord_plain on bf16 rows:
    the coordinates to fp32 noise."""
    g = torch.Generator().manual_seed(c)
    h = plain.bf16(torch.randn(2 * 50, c, generator=g))
    wo = plain.bf16(torch.randn(2, c, generator=g) * 0.02)
    bo = torch.randn(2, generator=g) * 0.02
    ct = torch.rand(50, 2, generator=g) * 1.2 - 0.1
    got = kpt_coord_rows(h, ct, wo, bo)
    want = tdec.kpt_coord_plain(h, ct, wo, bo)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 2e-6


# The CPU stand-ins of the kernels' entry points, behind the wrappers;
# the GEMM's mainloop of each call
MAINLOOPS = []
_DT = {K.F32: (ctypes.c_float, torch.float32),
       K.BF16: (ctypes.c_uint16, torch.bfloat16)}


def _view(ptr, dt, shape, strides):
    """The tensor of `shape` and element `strides` at address ptr: the
    memory of the wrapper's own tensor, written through."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    ct, tdt = _DT[dt]
    t = torch.from_numpy(np.ctypeslib.as_array((ct * n).from_address(ptr)))
    if tdt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.as_strided(shape, strides)


def _tma_ok(ptr, ld, sz, batch):
    return ptr % 16 == 0 and ld > 0 and ld % 8 == 0 and (
        batch == 1 or (sz >= 0 and sz % 8 == 0))


def _gemm(a, lda, sa, b, ldb, sb, b_nk, c, ldc, sc, c_dt, m, n, k, z, bias,
          pre, pre_dt, ldp, sp, act, res, res_dt, ldr, sr, ls, mainloop,
          stream):
    if mainloop not in (K.GEMM_COPY, K.GEMM_TMA, K.GEMM_TMA_SLABS):
        return 1
    if mainloop != K.GEMM_COPY and not (
            n >= K.GEMM_TMA_MIN_N and _tma_ok(a, lda, sa, z)
            and _tma_ok(b, ldb, sb, z)):
        return 1                          # ec_gemm refuses it
    MAINLOOPS.append(mainloop)
    av = _view(a, K.BF16, (z, m, k), (sa, lda, 1)).float()
    bv = _view(b, K.BF16, (z, n, k) if b_nk else (z, k, n),
               (sb, ldb, 1)).float()
    y = torch.matmul(av, bv.transpose(-1, -2) if b_nk else bv)
    if bias:
        y = y + _view(bias, K.F32, (n,), (1,))
    if pre:
        y = y + _view(pre, pre_dt, (z, m, n), (sp, ldp, 1)).float()
    if act == K.ACT_GELU:
        y = plain.gelu(y)
    elif act == K.ACT_RELU:
        y = torch.relu(y)
    if res:
        y = _view(res, res_dt, (z, m, n), (sr, ldr, 1)).float() + (
            _view(ls, K.F32, (n,), (1,)) * y if ls else y)
    out = _view(c, c_dt, (z, m, n), (sc, ldc, 1))
    out.copy_(y.to(out.dtype))
    return 0


def _layernorm(x, x_dt, ldx, r, r_dt, ldr, g, be, eps, of, ldof, ob, ldob,
               rows, c, stream):
    if c <= 0 or rows <= 0:
        return 1
    v = _view(x, x_dt, (rows, c), (ldx, 1)).float()
    if r:
        v = v + _view(r, r_dt, (rows, c), (ldr, 1)).float()
    y = ln_rows_any(v, _view(g, K.F32, (c,), (1,)),
                    _view(be, K.F32, (c,), (1,)), eps)
    if of:
        _view(of, K.F32, (rows, c), (ldof, 1)).copy_(y)
    if ob:
        _view(ob, K.BF16, (rows, c), (ldob, 1)).copy_(y.to(torch.bfloat16))
    return 0


def _add_pos(x, x_dt, pos, out, row_elems, total, stream):
    xv = plain.bf16(_view(x, x_dt, (total,), (1,)).float())
    pv = _view(pos, K.BF16, (row_elems,), (1,)).float()
    _view(out, K.BF16, (total,), (1,)).copy_(
        (xv.view(-1, row_elems) + pv).view(-1).to(torch.bfloat16))
    return 0


def _kpt_coord(h, wo, bo, ct, pts, outs, r, c, ieps, stream):
    if h % 4 or wo % 4:
        return 1
    p, o = kpt_coord_rows(_view(h, K.BF16, (2 * r, c), (c, 1)),
                          _view(ct, K.F32, (r, 2), (2, 1)),
                          _view(wo, K.BF16, (2, c), (c, 1)),
                          _view(bo, K.F32, (2,), (1,)), ieps)
    _view(pts, K.F32, (r, 2), (2, 1)).copy_(p)
    _view(outs, K.F32, (r, 2), (2, 1)).copy_(o)
    return 0


def _counted(name, fn):
    def run(*a, **kw):
        K.launches[name] += 1
        return fn(*a, **kw)
    return run


def _attention(q, k, v, *, num_heads, scale, key_valid=None, bias=None):
    kb = None if key_valid is None else plain.key_bias(key_valid)
    return plain.attention(q, k, v, num_heads=num_heads, scale=scale, kb=kb,
                           bias=bias).to(torch.bfloat16)


def _bias_attention(qkv, key_valid, hops, hop_mlp, *, num_heads):
    return tdec.bias_attention_plain(qkv, key_valid, hops, hop_mlp,
                                     num_heads=num_heads).to(torch.bfloat16)


def _sine_feats(ct, rdt):
    ax = (ct[:, 0:1] * 6.283185307179586) * rdt
    ay = (ct[:, 1:2] * 6.283185307179586) * rdt
    return torch.cat([torch.sin(ay), torch.cos(ay), torch.sin(ax),
                      torch.cos(ax)], dim=-1).to(torch.bfloat16)


@contextlib.contextmanager
def split_kernels(monkeypatch):
    """The split route on the CPU: every entry point it calls through
    `_call` by its stand-in above (the wrappers' own checks, pointers and
    strides unchanged), the attention kernels by their plain versions;
    the launch counters zeroed first, and the op modules' own counters
    restored on leaving (other tests hold them at 0 on the CPU). Yields
    K.launches."""
    entries = {"ec_gemm": _gemm, "ec_layernorm": _layernorm,
               "ec_add_pos": _add_pos, "ec_kpt_coord": _kpt_coord}

    def call(name, *args):
        if entries[name](*args):
            raise RuntimeError(f"{name} refused its arguments")
    with monkeypatch.context() as mp:
        mp.setattr(K, "_call", call)
        mp.setattr(K, "_cuda", lambda *ts: None)
        mp.setattr(K, "_stream", lambda: 0)
        mp.setattr(K, "attention", _counted("attn_kernel", _attention))
        mp.setattr(K, "bias_attention",
                   _counted("bias_attn_wide_kernel", _bias_attention))
        mp.setattr(K, "sine_feats",
                   _counted("sine_feats_kernel", _sine_feats))
        mp.setattr(K, "launches", dict.fromkeys(K.launches, 0))
        for mod in (tenc, tdec):
            mp.setattr(mod, "launches", mod.launches)
            mp.setattr(mod, "stack_launches", mod.stack_launches)
        yield K.launches


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("c,h", SPLIT)
def test_split_encoder_stack_matches_plain(monkeypatch, c, h):
    """The encoder's split route (ops/fused_encoder.py _stack_cuda over
    kernels.enc_post's five launches, add_pos between layers) against the
    plain layers, layer by layer, and the three-layer stack bit-equal to
    the chain of its layers; 1 + 8 L - 1 launches a stack."""
    rng = np.random.default_rng(c)
    f = 3 * c // 2
    layers = [_encoder(rng, c, f, h)[1] for _ in range(3)]
    b, n = 2, 28
    tokens = T(rng.normal(size=(b, n, c)).astype(np.float32)).to(
        torch.bfloat16)
    pos = T(rng.normal(size=(n, c)).astype(np.float32))
    valid = T(rng.uniform(size=(b, n)) > 0.3)
    valid[:, 0] = True
    with torch.no_grad(), split_kernels(monkeypatch) as counts:
        x, chain = tokens, []
        for layer in layers:
            ref = tenc.fused_encoder_layer_plain(x, pos, valid, layer,
                                                 num_heads=h)
            out = tenc._stack_cuda(x, pos, valid, [layer], num_heads=h,
                                   eps=1e-5)
            _close(out, ref)
            chain.append(out)
            x = out
        counts.update(dict.fromkeys(counts, 0))
        stack = tenc._stack_cuda(tokens, pos, valid, layers, num_heads=h,
                                 eps=1e-5)
        assert _nonzero(counts) == {"gemm_tma_kernel": 3 * 4,
                                    "layernorm_kernel": 6,
                                    "add_pos_kernel": 3, "attn_kernel": 3}
    x = tokens
    with torch.no_grad(), split_kernels(monkeypatch):
        for layer in layers:
            x = tenc._stack_cuda(x, pos, valid, [layer], num_heads=h,
                                 eps=1e-5)
    assert torch.equal(stack, x) and stack.dtype == torch.bfloat16
    with torch.no_grad():                   # fp32 tokens: an fp32 output
        ref = tenc.fused_encoder_layer_plain(tokens.float(), pos, valid,
                                             layers[0], num_heads=h)
        with split_kernels(monkeypatch):
            out = tenc._stack_cuda(tokens.float(), pos, valid, layers[:1],
                                   num_heads=h, eps=1e-5)
    assert out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.parametrize("c,h", SPLIT)
@pytest.mark.parametrize("k", [12, 133])
def test_split_decoder_layer_matches_plain(monkeypatch, c, h, k):
    """The decoder layer's split route: dec_post_self's three launches
    against post_self_plain and cross_query_plain, dec_post_cross's eight
    (the adjacency contraction as two batched GEMMs over rows at a stride
    of K rounded up to 8) against post_cross_plain, on the same inputs, to
    fp32 noise (ULP_MAX / NOISE_MEAN); the whole layer, 17 launches with
    every GEMM on the TMA mainloop, against the plain layer to BF16_MAX /
    BF16_MEAN: its cross-attention keys are two products on the card
    (the image half, and the position half once a call, added in the
    epilogue) where the plain layer has one, so some bf16 keys round the
    other way, as at every width."""
    rng = np.random.default_rng(c + k)
    _, layer = _decoder(rng, c, 3 * c // 2, h)
    x, qpos, img, ipos, valid, bias, adj = _decoder_inputs(rng, 2, k, 16, c,
                                                           h)
    args = [T(a).to(torch.bfloat16) for a in (x, qpos, img, ipos)] + [
        T(valid), T(bias), T(adj)]
    r, w = 2 * k, tdec._prepare(layer)
    att = T(rng.normal(size=(r, c)).astype(np.float32)).to(torch.bfloat16)
    att2 = T(rng.normal(size=(2, k, 2 * c)).astype(np.float32)).to(
        torch.bfloat16)
    xb, qp = args[0].view(r, c), args[1].view(r, c)
    with torch.no_grad():
        x1r = tdec.post_self_plain(att.float(), xb, layer)
        q2r = tdec.cross_query_plain(x1r, qp, layer)
        outr = tdec.post_cross_plain(att2.float(), x1r.view(2, k, c),
                                     args[6], layer)
        ref = tdec.fused_decoder_layer_plain(*args, layer, num_heads=h)
        with split_kernels(monkeypatch) as counts:
            MAINLOOPS.clear()
            x1, q2 = K.dec_post_self(att, xb, qp, w, eps=1e-5)
            half = K.dec_post_cross(att2, x1r, args[6], w, eps=1e-5,
                                    out_dtype=torch.float32)
            assert _nonzero(counts) == {"gemm_tma_kernel": 2 + 6,
                                        "layernorm_kernel": 1 + 2}
            # the split route's products sum each 64-deep k tile apart
            assert MAINLOOPS == [K.GEMM_TMA_SLABS] * 8
            counts.update(dict.fromkeys(counts, 0))
            out = tdec._fused_decoder_layer_cuda(*args, layer, num_heads=h,
                                                 eps=1e-5)
            assert _nonzero(counts) == {"gemm_tma_kernel": 12,
                                        "layernorm_kernel": 3,
                                        "attn_kernel": 2}
    _close(x1, x1r)
    _close(q2, plain.bf16(q2r))         # the query is bf16
    _close(half.view(2, k, c), outr)
    assert out.dtype == torch.bfloat16 and out.shape == (2, k, c)
    _close(out, ref, BF16_MAX, BF16_MEAN)


@pytest.mark.parametrize("c,h,k", [(576, 9, 12), (640, 10, 133)])
def test_split_decoder_stack_matches_plain(monkeypatch, c, h, k):
    """The decoder stack's split route (qpos and each layer's output
    written in place into the query product's and the keypoint head's
    inputs, the adjacency laid out once, the keypoint head's three GEMMs
    over both passes and kpt_coord_kernel) against the plain stack, each
    layer alone (STACK_LAYER_MAX / STACK_LAYER_MEAN); 3 + 22 L launches."""
    rng = np.random.default_rng(c + k + 1)
    ff, nf, layers = 3 * c // 2, c // 2, 3
    tree = decoder_tree(rng, c, h, ff, layers)
    inp = decoder_inputs(rng, 2, k, 16, c)
    kw = dict(num_heads=h, num_feats=nf)
    with torch.no_grad():
        for i in range(layers):
            sub = {"ref_point_head": tree["ref_point_head"],
                   "norm": tree["norm"], "layer0": tree[f"layer{i}"],
                   "kpt_branch0": tree[f"kpt_branch{i}"]}
            dec = decoder(sub, c, h, ff, 1, nf)
            ro, rp = tdec.fused_decoder_stack_plain(*_args(inp), dec, **kw)
            with split_kernels(monkeypatch):
                o, p = tdec._fused_decoder_stack_cuda(*_args(inp), dec,
                                                      eps=1e-5, **kw)
            d = torch.cat([(o - ro).abs().flatten(), (p - rp).abs().flatten()])
            assert d.max().item() <= STACK_LAYER_MAX, (i, d.max().item())
            assert d.mean().item() <= STACK_LAYER_MEAN, (i, d.mean().item())
        with split_kernels(monkeypatch) as counts:
            o, p = tdec._fused_decoder_stack_cuda(
                *_args(inp), decoder(tree, c, h, ff, layers, nf), eps=1e-5,
                **kw)
            assert _nonzero(counts) == {
                "gemm_tma_kernel": 3 + 14 * layers,
                "layernorm_kernel": 4 * layers, "attn_kernel": layers,
                "bias_attn_wide_kernel": layers, "sine_feats_kernel": layers,
                "kpt_coord_kernel": layers}
    assert o.shape == p.shape == (layers, 2, k, 2)
    assert bool(torch.isfinite(o).all() and torch.isfinite(p).all())


def test_split_wrappers_take_their_buffers_as_given(monkeypatch):
    """dec_post_self reads qpos in place when it is the second half of the
    given qin, kpt_head reads x in place when it is the first half of kin,
    gcn_adjacency returns a laid-out adjacency as it is; layernorm writes a
    column block of a wider buffer at that buffer's row stride. gemm
    refuses slabs on operands the TMA mainloop does not take (a row
    stride of no multiple of 8, fewer than GEMM_TMA_MIN_N columns)
    instead of summing them on another mainloop."""
    c, r = 576, 24
    g = torch.Generator().manual_seed(5)
    with split_kernels(monkeypatch):
        qin = torch.zeros(r, 2 * c, dtype=torch.bfloat16)
        x = torch.randn(r, c, generator=g)
        gamma, beta = torch.ones(c), torch.zeros(c)
        K.layernorm(x, gamma, beta, 1e-5, out_f32=False,
                    out_bf16=qin[:, :c])
        assert torch.equal(qin[:, :c], ln_rows_any(x, gamma, beta).to(
            torch.bfloat16)) and not qin[:, c:].any()
        adj = torch.rand(3, 2, 13, 13, generator=g)
        a = K.gcn_adjacency(adj)
        assert a.stride() == (2 * 13 * 16, 13 * 16, 16, 1)
        assert torch.equal(a.float(), plain.bf16(adj))
        assert K.gcn_adjacency(a) is a
        with pytest.raises(ValueError, match="does not fit"):
            K._ln_out(torch.zeros(r, 2 * c)[:, ::2], x, torch.float32)
        bf = torch.bfloat16
        for a, b in ((torch.ones(r, 580, dtype=bf),
                      torch.ones(64, 580, dtype=bf)),
                     (torch.ones(r, c, dtype=bf), torch.ones(24, c, dtype=bf))):
            with pytest.raises(ValueError, match="slabs run on the TMA"):
                K.gemm(a, b, b_nk=True, slabs=True)
            assert K.gemm(a, b, b_nk=True).shape == (r, b.shape[0])


# ------------------------------------------------------------- JAX kernels
@pytest.mark.parametrize("c,h", SPLIT)
def test_encoder_stack_plain_matches_jax_kernel_past_512(c, h):
    """#3 at 576 / 9 and 640 / 10: the port's plain stack against the JAX
    fused_encoder_stack in interpret mode (bf16 tokens), layer by layer
    (a bf16 ulp grows through layers: ROADMAP hazards), each layer to
    BF16_MAX / BF16_MEAN."""
    rng = np.random.default_rng(c + 3)
    f = 3 * c // 2
    pairs = [_encoder(rng, c, f, h) for _ in range(2)]
    b, n = 2, 28
    tokens = rng.normal(size=(b, n, c)).astype(np.float32)
    pos = rng.normal(size=(n, c)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[:, 0] = True
    x = jnp.asarray(tokens).astype(jnp.bfloat16)
    for i in range(2):          # each layer on the JAX stack's input to it
        ref = jenc.fused_encoder_stack(
            x, jnp.asarray(pos), jnp.asarray(valid),
            (_encoder_args(pairs[i][0]),), num_heads=h, eps=1e-5,
            interpret=True)
        with torch.no_grad():
            out = tenc.fused_encoder_stack(
                T(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
                T(pos), T(valid), [pairs[i][1]], num_heads=h)
        _close(out, ref.astype(jnp.float32), BF16_MAX, BF16_MEAN)
        x = ref


@pytest.mark.parametrize("c,h", SPLIT)
@pytest.mark.parametrize("k", [12, 133])
def test_decoder_layer_plain_matches_jax_kernel_past_512(c, h, k):
    """#4 (#4K at 133 keypoints) at 576 / 9 and 640 / 10: the port's plain
    layer against the JAX fused_decoder_layer in interpret mode."""
    rng = np.random.default_rng(c + k + 4)
    tree, layer = _decoder(rng, c, 3 * c // 2, h)
    x, qpos, img, ipos, valid, bias, adj = _decoder_inputs(rng, 2, k, 16, c,
                                                           h)
    ref = jdec.fused_decoder_layer(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (x, qpos, img, ipos)),
        jnp.asarray(valid), jnp.asarray(bias), jnp.asarray(adj), tree,
        num_heads=h, eps=1e-5, interpret=True)
    with torch.no_grad():
        out = tdec.fused_decoder_layer(
            *(T(a).to(torch.bfloat16) for a in (x, qpos, img, ipos)),
            T(valid), T(bias), T(adj), layer, num_heads=h)
    _close(out, ref.astype(jnp.float32), BF16_MAX, BF16_MEAN)


@pytest.mark.parametrize("c,h,k", [(576, 9, 12), (640, 10, 133)])
def test_decoder_stack_plain_matches_jax_kernel_past_512(c, h, k):
    """#5 (#5K at 133 keypoints): the port's plain stack, one layer,
    against the JAX fused_decoder_stack in interpret mode on coordinates
    in [0, 1] (STACK_LAYER_MAX / STACK_LAYER_MEAN, as
    tests/test_torch_kpts.py holds it at 64 and 256 channels)."""
    rng = np.random.default_rng(c + k + 5)
    ff, nf = 3 * c // 2, c // 2
    tree = decoder_tree(rng, c, h, ff, 1)
    inp = decoder_inputs(rng, 2, k, 16, c)
    lp = ({"dec": tree["layer0"], "kpt": tree["kpt_branch0"],
           "bias_mlp": tree["layer0"]["bias_mlp"]},)
    jo, jp = jdec.fused_decoder_stack(
        jnp.asarray(inp["x"]).astype(jnp.bfloat16),
        *(jnp.asarray(inp[n]) for n in ("coords", "img", "ipos", "valid",
                                         "hops", "adj")),
        lp, tree["ref_point_head"], tree["norm"], num_heads=h,
        num_feats=nf, eps=1e-5, interpret=True)
    o, p = tdec.fused_decoder_stack(*_args(inp),
                                    decoder(tree, c, h, ff, 1, nf),
                                    num_heads=h, num_feats=nf)
    for t, j in ((o, jo), (p, jp)):
        d = np.abs(t.numpy() - np.asarray(j, np.float32))
        assert d.max() <= STACK_LAYER_MAX, d.max()
        assert d.mean() <= STACK_LAYER_MEAN, d.mean()


# ------------------------------------------------------------- the slice
WIDE640 = dict(d_model=640, nhead=10, num_feats=320, dim_feedforward=960,
               similarity_proj_dim=640)


def test_forward_cached_at_640_channels_matches_jax_strict():
    """The stage-3 model at 640 / 10 over the toy trunk: the port's fp32
    forward_cached (plain path) against the JAX strict path on the same
    weights; the width check takes the model."""
    cfg = _cfg(**WIDE640)
    misfits = K.width_misfits(cfg.model, vit_heads=TRUNK.num_heads)
    assert all(why is None for why in misfits.values()), misfits
    bb = jdinov2.init_params(jax.random.PRNGKey(0), SIZE, TRUNK)
    est = JaxEstimator(cfg, backbone_params=bb, rng=jax.random.PRNGKey(3))
    weights = _perturb(bb, est.head_params, seed=12)
    support, query = _episodes(seed=3)
    jpred, jadj = _jax_estimator(cfg, weights).forward_cached(support, query)
    tpred, tadj = _torch_estimator(cfg, weights).forward_cached(support,
                                                                query)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)
