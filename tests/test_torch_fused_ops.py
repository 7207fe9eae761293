"""The four kernel ops of the port, through their plain PyTorch versions
(CPU tensors), against the JAX Pallas kernels run in interpret mode.

Same numpy-drawn inputs and weights on both sides; LayerScale 1 and
non-zero biases so every sub-step shows. Both sides round to bf16 at the
same points, but the frameworks sum in different orders, so a value can
land one bf16 ulp apart and carry that through the rest of the op.
Tolerances are therefore bf16-sized on outputs of order 1 (bf16 ulp is
2^-7 near 1): BF16_MAX on the largest and BF16_MEAN on the mean absolute
difference. The ViT block adds the tanh-vs-erf GELU gap (the TPU kernel
uses tanh, the port the model's exact erf); its size at these inputs is
measured in the test and added to the tolerance. Most of the encoder's
difference comes from the JAX kernel itself: in interpret mode its LN1
residual sees `x + pos` unrounded although its source rounds it to bf16
(XLA drops the round trip); the port rounds as the source says."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import fused_decoder as jdec
from edgecape_tpu.ops import fused_encoder as jenc
from edgecape_tpu.ops import fused_vit_block as jvit
from edgecape_tpu.ops import flash_attention as jflash
from edgecape_tpu_torch.models.convert import state_from_flax
from edgecape_tpu_torch.models.dinov2 import Block, DinoV2Config
from edgecape_tpu_torch.models.transformer import DecoderLayer, EncoderLayer
from edgecape_tpu_torch.ops import fused_decoder as tdec
from edgecape_tpu_torch.ops import fused_encoder as tenc
from edgecape_tpu_torch.ops import fused_vit_block as tvit
from edgecape_tpu_torch.ops import flash_attention as tflash

BF16_MAX = 0.0625
BF16_MEAN = 0.004


def _check(t, j, max_tol=BF16_MAX, mean_tol=BF16_MEAN):
    d = np.abs(t.detach().float().numpy() - np.asarray(j, np.float32))
    assert d.max() <= max_tol, d.max()
    assert d.mean() <= mean_tol, d.mean()


def _dense(rng, i, o):
    return {"kernel": (rng.normal(size=(i, o)) / math.sqrt(i)).astype(
        np.float32), "bias": (rng.normal(size=o) * 0.1).astype(np.float32)}


def _ln(rng, c):
    return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}


def _mha(rng, e, q_dim, v_dim):
    return {"q_proj": _dense(rng, q_dim, e), "k_proj": _dense(rng, q_dim, e),
            "v_proj": _dense(rng, v_dim, e), "out_proj": _dense(rng, e, e)}


def _load(module, tree):
    module.load_state_dict(state_from_flax(tree))
    return module


# ------------------------------------------------------------- ViT block
def test_fused_vit_block_plain_matches_jax_kernel():
    rng = np.random.default_rng(0)
    b, n, c, heads, f = 2, 20, 128, 2, 256
    tree = {"norm1": _ln(rng, c), "norm2": _ln(rng, c),
            "ls1_gamma": np.ones(c, np.float32),
            "ls2_gamma": np.ones(c, np.float32),
            "attn": {"qkv": _dense(rng, c, 3 * c),
                     "proj": _dense(rng, c, c)},
            "mlp_fc1": _dense(rng, c, f), "mlp_fc2": _dense(rng, f, c)}
    cfg = DinoV2Config(embed_dim=c, num_heads=heads, mlp_ratio=f / c)
    blk = _load(Block(cfg), tree)
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    wqkv, bqkv = tree["attn"]["qkv"]["kernel"], tree["attn"]["qkv"]["bias"]
    args = (jnp.asarray(x).astype(jnp.bfloat16),
            tree["norm1"]["scale"], tree["norm1"]["bias"],
            wqkv[:, :c], bqkv[:c], wqkv[:, c:2 * c], bqkv[c:2 * c],
            wqkv[:, 2 * c:], bqkv[2 * c:], tree["attn"]["proj"]["kernel"],
            tree["attn"]["proj"]["bias"], tree["ls1_gamma"],
            tree["norm2"]["scale"], tree["norm2"]["bias"],
            tree["mlp_fc1"]["kernel"], tree["mlp_fc1"]["bias"],
            tree["mlp_fc2"]["kernel"], tree["mlp_fc2"]["bias"],
            tree["ls2_gamma"])
    ref = np.asarray(jvit.fused_vit_block(
        *args, num_heads=heads, eps=1e-6, interpret=True).astype(jnp.float32))
    out = tvit.fused_vit_block(torch.from_numpy(x).to(torch.bfloat16), blk,
                               num_heads=heads, eps=1e-6)
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, c)
    # the GELU gap at these inputs, pushed through fc2 (LayerScale 1)
    h = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32)) * 2
    tanh_gelu = torch.nn.functional.gelu(h, approximate="tanh")
    gap = float((tanh_gelu - torch.nn.functional.gelu(h)).abs().max())
    w2 = np.abs(tree["mlp_fc2"]["kernel"]).sum(axis=0).max()
    _check(out, ref, max_tol=BF16_MAX + gap * w2, mean_tol=0.01)
    assert tvit.launches == 0      # CPU tensors take the plain version


# ---------------------------------------------------------- encoder layer
def _encoder_tree(rng, c, f):
    return {"self_attn": _mha(rng, c, c, c), "norm1": _ln(rng, c),
            "linear1": _dense(rng, c, f), "linear2": _dense(rng, f, c),
            "norm2": _ln(rng, c)}


def _encoder_args(tree):
    at = tree["self_attn"]
    return (at["q_proj"]["kernel"], at["q_proj"]["bias"],
            at["k_proj"]["kernel"], at["k_proj"]["bias"],
            at["v_proj"]["kernel"], at["v_proj"]["bias"],
            at["out_proj"]["kernel"], at["out_proj"]["bias"],
            tree["norm1"]["scale"], tree["norm1"]["bias"],
            tree["linear1"]["kernel"], tree["linear1"]["bias"],
            tree["linear2"]["kernel"], tree["linear2"]["bias"],
            tree["norm2"]["scale"], tree["norm2"]["bias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_encoder_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(1)
    b, n, c, heads, f = 3, 22, 64, 2, 96
    trees = [_encoder_tree(rng, c, f) for _ in range(2)]
    layers = [_load(EncoderLayer(c, heads, f), t) for t in trees]
    tokens = rng.normal(size=(b, n, c)).astype(np.float32)
    pos = rng.normal(size=(n, c)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[:, 0] = True
    jt = jnp.asarray(tokens).astype(dtype)
    ref_layer = jenc.fused_encoder_layer(
        jt, jnp.asarray(pos), jnp.asarray(valid), *_encoder_args(trees[0]),
        num_heads=heads, eps=1e-5, interpret=True)
    ref_stack = jenc.fused_encoder_stack(
        jt, jnp.asarray(pos), jnp.asarray(valid),
        tuple(_encoder_args(t) for t in trees), num_heads=heads, eps=1e-5,
        interpret=True)
    tt = torch.from_numpy(tokens).to(getattr(torch, dtype))
    out_layer = tenc.fused_encoder_layer(
        tt, torch.from_numpy(pos), torch.from_numpy(valid), layers[0],
        num_heads=heads)
    out_stack = tenc.fused_encoder_stack(
        tt, torch.from_numpy(pos), torch.from_numpy(valid), layers,
        num_heads=heads)
    assert out_stack.dtype == tt.dtype
    _check(out_layer, ref_layer.astype(jnp.float32))
    _check(out_stack, ref_stack.astype(jnp.float32))
    assert tenc.launches == 0 and tenc.stack_launches == 0


# ---------------------------------------------------------- decoder layer
def test_fused_decoder_plain_matches_jax_kernel():
    _decoder_layer_case(2, 3, 12, 16, 64, 2, 96)


def test_fused_decoder_at_cross_head_dim_128_past_416_keys_matches_jax():
    """A head of 128 channels in 2 heads (the cross-attention's head dim
    2 x 128 / 2 = 128) over 484 image keys (308 px, 22 x 22 patches): on
    the card past the resident attention's 416 keys, so attn_long_kernel
    at head dim 128. The port's op (its plain version on the CPU, bf16
    tokens and fp32 weights as the op takes them) against the JAX kernel in
    interpret mode to the same bf16-sized bounds."""
    _decoder_layer_case(26, 2, 8, 22 * 22, 128, 2, 256)


def _decoder_layer_case(seed, b, k, hw, c, heads, f):
    """fused_decoder_layer's plain version against the JAX kernel at
    batch b, k keypoints, hw image keys, c channels in `heads` heads and a
    GCN of f."""
    rng = np.random.default_rng(seed)
    tree = {"self_attn": _mha(rng, c, c, c), "norm1": _ln(rng, c),
            "cross_attn": _mha(rng, 2 * c, 2 * c, c),
            "choker": _dense(rng, 2 * c, c), "norm2": _ln(rng, c),
            "gcn": {"conv": _dense(rng, c, 2 * f)},
            "ffn2": _dense(rng, f, c), "norm3": _ln(rng, c)}
    layer = _load(DecoderLayer(c, heads, f), tree)
    x = rng.normal(size=(b, k, c)).astype(np.float32)
    qpos = rng.normal(size=(b, k, c)).astype(np.float32)
    img = rng.normal(size=(b, hw, c)).astype(np.float32)
    ipos = rng.normal(size=(hw, c)).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.3
    valid[:, 0] = True
    bias = rng.normal(size=(b, heads, k, k)).astype(np.float32)
    adj = rng.uniform(size=(b, 2, k, k)).astype(np.float32) / k
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, qpos, img, ipos)]
    ref = jdec.fused_decoder_layer(
        *jx, jnp.asarray(valid), jnp.asarray(bias), jnp.asarray(adj), tree,
        num_heads=heads, eps=1e-5, interpret=True)
    tx = [torch.from_numpy(a).to(torch.bfloat16)
          for a in (x, qpos, img, ipos)]
    out = tdec.fused_decoder_layer(
        *tx, torch.from_numpy(valid), torch.from_numpy(bias),
        torch.from_numpy(adj), layer, num_heads=heads)
    assert out.dtype == torch.bfloat16
    _check(out, ref.astype(jnp.float32))
    assert tdec.launches == 0


# ------------------------------------------------------------- flash_mha
@pytest.mark.parametrize("masked", [False, True])
def test_flash_mha_plain_matches_jax_kernel(masked):
    rng = np.random.default_rng(3)
    b, n, h, d = 3, 12, 4, 32
    q, k, v = (rng.normal(size=(b, n, h, d)).astype(np.float32)
               for _ in range(3))
    valid = rng.uniform(size=(b, n)) > 0.4
    valid[:, 0] = True
    jv = jnp.asarray(valid) if masked else None
    ref = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jv, interpret=True)
    tv = torch.from_numpy(valid) if masked else None
    out = tflash.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), tv)
    assert out.dtype == torch.float32
    # outputs are convex mixtures of bf16 values of order 1: one bf16 ulp
    _check(out, ref, max_tol=2 ** -7 * 2, mean_tol=1e-3)
    assert tflash.launches == 0
