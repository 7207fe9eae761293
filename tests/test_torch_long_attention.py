"""The streaming attention kernels (csrc/attn_long.cu), which take rows
longer than the resident kernels hold, on the CPU: their launch plans,
the width check at the image sizes they open, emulations of their tile
loops in torch against the plain versions and the JAX kernels in
interpret mode, and the training route above 512 tokens against the JAX
module. (The stage-3 slice at DINOv2's own 518 px against the JAX package
is tests/test_torch_width_routes.py's, on that file's weights.)

attn_long_kernel's emulation (emulate_forward_online) keeps its one pass:
key tiles of 128 in order, each row's running max in base 2 and its
quad's running sums, the unnormalised p rounded to bf16 for P.V, the
output rescaled when the max grows and divided by the sum at the end.
The training kernels' emulations keep the two-pass form: 32-key chunks
of a warp's scores, per-lane running max and exp-sum over them (a lane
holds four neighbouring keys of each 16-key block), joined over the
quad; a second pass that normalises by the final sum before the bf16
rounding of the probabilities and adds P.V 16 keys at a time in fp32;
keys arriving in tiles of LONG_TILE, queries of the key-major backward
likewise. Tolerances:

* the one-pass emulation against the plain attention and JAX flash_mha
  in interpret mode: see test_online_forward_emulation_matches_plain_and_jax
  (another rounding point of p: one bf16 ulp of the largest output);
* the two-pass emulation against the plain attention and against JAX
  flash_mha in interpret mode (the same bf16 operands and rounding
  points, softmax summed in another order): the probabilities before
  their rounding within 1e-7 of torch's fp32 softmax (fp32 rounding of
  values <= 1; measured 1.5e-8), the outputs within one bf16 ulp of the
  largest (a probability whose fp32 value lies on a bf16 rounding
  boundary may round the other way; measured a quarter of it) and 1e-5
  on the mean (measured 1.6e-7);
* the training forward's statistics against fp64: 1e-6 relative
  (measured 5e-7); its output and the backward's dq, dk, dv against the
  JAX pair in interpret mode: 5e-4 absolute on values of order 1 (the
  flipped roundings above; measured 1.7e-4), dbias (fp32, no rounding of
  its own) 1e-5 (measured 6e-7);
* the training route: see test_training_rows_above_512_take_the_fp32_plain_path.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.models import dinov2 as jdinov2
from edgecape_tpu.models import transformer as jtransformer
from edgecape_tpu.ops import flash_attention as jflash
from edgecape_tpu_torch.config import ModelConfig
from edgecape_tpu_torch.models import convert as tconvert
from edgecape_tpu_torch.models import transformer as ttransformer
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain

SMEM_LIMIT = 232448
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
CHUNK = 16 * K.ATT_CH16             # keys of a warp's register chunk

# ------------------------------------------------------------------ plans
# attention_plan, attention_bwd_plan and vit_attn_plan as they were before
# the streaming kernels existed: every shape they took keeps its plan, so
# the 224 px path launches the same kernels.
FWD_PLANS = [
    ((257, 257, 64, False, None), {'q_split': 2, 'warps': 9, 'one_pass': False, 'smem_bytes': 100160, 'key_tiles': 17, 'chunk_tiles': 2}),  # noqa: E501
    ((356, 356, 32, False, None), {'q_split': 2, 'warps': 12, 'one_pass': False, 'smem_bytes': 75712, 'key_tiles': 23, 'chunk_tiles': 2}),  # noqa: E501
    ((100, 100, 32, False, None), {'q_split': 2, 'warps': 4, 'one_pass': True, 'smem_bytes': 23488, 'key_tiles': 7, 'chunk_tiles': 8}),  # noqa: E501
    ((100, 256, 64, False, None), {'q_split': 1, 'warps': 7, 'one_pass': False, 'smem_bytes': 90880, 'key_tiles': 16, 'chunk_tiles': 2}),  # noqa: E501
    ((356, 356, 32, True, None), {'q_split': 2, 'warps': 12, 'one_pass': False, 'smem_bytes': 75712, 'key_tiles': 23, 'chunk_tiles': 2}),  # noqa: E501
    ((100, 100, 32, True, None), {'q_split': 2, 'warps': 4, 'one_pass': True, 'smem_bytes': 23488, 'key_tiles': 7, 'chunk_tiles': 8}),  # noqa: E501
    ((325, 325, 64, False, None), {'q_split': 3, 'warps': 7, 'one_pass': False, 'smem_bytes': 114240, 'key_tiles': 21, 'chunk_tiles': 2}),  # noqa: E501
    ((1, 1, 32, False, None), {'q_split': 1, 'warps': 1, 'one_pass': True, 'smem_bytes': 3904, 'key_tiles': 1, 'chunk_tiles': 8}),  # noqa: E501
    ((512, 512, 64, False, None), {'q_split': 4, 'warps': 8, 'one_pass': False, 'smem_bytes': 167936, 'key_tiles': 32, 'chunk_tiles': 2}),  # noqa: E501
    ((40, 512, 32, True, None), {'q_split': 1, 'warps': 3, 'one_pass': False, 'smem_bytes': 87808, 'key_tiles': 32, 'chunk_tiles': 2}),  # noqa: E501
    ((100, 100, 32, False, 2), {'q_split': 1, 'warps': 7, 'one_pass': False, 'smem_bytes': 27328, 'key_tiles': 7, 'chunk_tiles': 2}),  # noqa: E501
    ((257, 257, 64, False, 2), {'q_split': 2, 'warps': 9, 'one_pass': False, 'smem_bytes': 100160, 'key_tiles': 17, 'chunk_tiles': 2}),  # noqa: E501
]
BWD_PLANS = [
    ((356, 356, 32, None), {'q_split': 3, 'q_warps': 8, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 80832, 'k_split': 3, 'k_warps': 8, 'k_smem_bytes': 85248, 'q_tiles': 23, 'key_tiles': 23}),  # noqa: E501
    ((100, 100, 32, None), {'q_split': 2, 'q_warps': 4, 'one_pass': True, 'chunk_tiles': 8, 'q_smem_bytes': 28608, 'k_split': 2, 'k_warps': 4, 'k_smem_bytes': 29952, 'q_tiles': 7, 'key_tiles': 7}),  # noqa: E501
    ((257, 257, 64, None), {'q_split': 3, 'q_warps': 6, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 107072, 'k_split': 3, 'k_warps': 6, 'k_smem_bytes': 110336, 'q_tiles': 17, 'key_tiles': 17}),  # noqa: E501
    ((512, 512, 64, None), {'q_split': 4, 'q_warps': 8, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 186368, 'k_split': 4, 'k_warps': 8, 'k_smem_bytes': 192512, 'q_tiles': 32, 'key_tiles': 32}),  # noqa: E501
    ((100, 100, 32, 2), {'q_split': 2, 'q_warps': 4, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 28608, 'k_split': 2, 'k_warps': 4, 'k_smem_bytes': 29952, 'q_tiles': 7, 'key_tiles': 7}),  # noqa: E501
    ((1, 512, 32, None), {'q_split': 1, 'q_warps': 1, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 86528, 'k_split': 8, 'k_warps': 4, 'k_smem_bytes': 13056, 'q_tiles': 1, 'key_tiles': 32}),  # noqa: E501
]
VIT_PLANS = [
    ((510, 257), {'qkv_tiles': 1024, 'items': 1530, 'items_per_image': 3, 'query_tiles': 5, 'pad_rows': 127, 'key_pad': 272, 'smem_bytes': 221312}),  # noqa: E501
    ((34, 257), {'qkv_tiles': 69, 'items': 102, 'items_per_image': 3, 'query_tiles': 5, 'pad_rows': 127, 'key_pad': 272, 'smem_bytes': 221312}),  # noqa: E501
    ((32, 257), {'qkv_tiles': 65, 'items': 96, 'items_per_image': 3, 'query_tiles': 5, 'pad_rows': 127, 'key_pad': 272, 'smem_bytes': 221312}),  # noqa: E501
    ((1, 272), {'qkv_tiles': 3, 'items': 3, 'items_per_image': 3, 'query_tiles': 5, 'pad_rows': 112, 'key_pad': 272, 'smem_bytes': 221312}),  # noqa: E501
    ((3, 1), {'qkv_tiles': 1, 'items': 3, 'items_per_image': 1, 'query_tiles': 1, 'pad_rows': 127, 'key_pad': 272, 'smem_bytes': 221312}),  # noqa: E501
]


@pytest.mark.parametrize("kind", ["forward", "backward", "vit"])
def test_plans_up_to_the_caps_are_unchanged(kind):
    if kind == "forward":
        for (nq, nk, d, train, chunk), want in FWD_PLANS:
            assert K.attention_plan(nq, nk, d, train=train,
                                    chunk_tiles=chunk) == want
    elif kind == "backward":
        for (nq, nk, d, chunk), want in BWD_PLANS:
            assert K.attention_bwd_plan(nq, nk, d, chunk_tiles=chunk) == want
    else:
        for (b, n), want in VIT_PLANS:
            assert K.vit_attn_plan(b, n, 384, 6) == want
    # no plan up to the caps streams
    for nk in (1, 17, 128, 129, 356, 511, 512):
        assert "long" not in K.attention_plan(100, nk, 32)
        assert "long" not in K.attention_bwd_plan(nk, nk, 32)
    for n in (1, 257, 272):
        assert "long" not in K.vit_attn_plan(2, n, 384, 6)


def _long_smem(d, warps, per_warp, query_stage):
    """The shared memory csrc/attn_long.cu lays out: a ring of two stages
    of 64 rows (k and v with the key mask, or q and do with 16 bytes of
    statistics) and `per_warp` 16-row tiles a warp."""
    kld = d + 8
    stage = 4 * 64 * kld + (16 if query_stage else 4) * 64
    return 2 * stage + 32 * per_warp * warps * kld


def _covers(split, warps, n):
    tiles = -(-n // 16)
    return (split - 1) * warps < tiles <= split * warps


def _stream_smem(d):
    """The shared memory attn_long_kernel lays out: 1024 bytes to align
    the tiles on, two query slots of 128 rows, a ring of four stages of a
    128-key K and V tile and 1024 bytes for the key mask, 128 bytes of
    barriers."""
    tile = 128 * 2 * d
    return 1024 + 2 * tile + 4 * (2 * tile + 1024) + 128


@pytest.mark.parametrize("nk", [513, 1025, 1369, 1469, 4096])
@pytest.mark.parametrize("d", [32, 64])
def test_long_plans_above_the_caps(nk, d):
    """Above 512 keys the streaming plans. The eval forward's
    (attn_long_kernel): one pass, items of 128 query rows a (batch, head),
    blocks of 12 warps (two consumer warpgroups and the producer's), key
    tiles of 128 through a ring of 4, shared memory as the kernel lays it
    out and within the card's limit. The training forward's: every query
    tile in one block of at most 8 warps and two passes, as before; a
    cross-attention of 100 queries too."""
    for nq in (1, 100, 128, 129, nk):
        plan = K.attention_plan(nq, nk, d)
        assert plan == {"long": True, "q_split": -(-nq // 128), "warps": 12,
                        "one_pass": True, "smem_bytes": _stream_smem(d),
                        "key_tiles": -(-nk // 128), "stages": 4}
        assert plan["smem_bytes"] <= SMEM_LIMIT
        train = K.attention_plan(nq, nk, d, train=True)
        assert train["long"] and not train["one_pass"]
        assert train["chunk_tiles"] == K.ATT_CH16
        assert train["key_tiles"] == -(-nk // 16)
        assert 1 <= train["warps"] <= 8 and _covers(train["q_split"],
                                                    train["warps"], nq)
        assert train["smem_bytes"] == _long_smem(d, train["warps"], 1, False)
        assert train["smem_bytes"] <= SMEM_LIMIT
    bwd = K.attention_bwd_plan(nk, nk, d)
    assert bwd["long"]
    for side, n in (("q", nk), ("k", nk)):
        warps = bwd[f"{side}_warps"]
        assert 1 <= warps <= 8 and _covers(bwd[f"{side}_split"], warps, n)
        assert bwd[f"{side}_smem_bytes"] == _long_smem(d, warps, 2,
                                                       side == "k")
        assert bwd[f"{side}_smem_bytes"] <= SMEM_LIMIT
    # the forcing argument runs them at a short shape; chunk_tiles forces
    # the resident kernels, which do not hold these rows
    assert K.attention_plan(356, 356, d, long=True) == K.attention_plan(
        356, nk, d) | {"q_split": 3, "key_tiles": 3}
    assert not K.attention_plan(356, 356, d, train=True,
                                long=True)["one_pass"]
    assert K.attention_bwd_plan(100, 100, d, long=True)["long"]
    with pytest.raises(ValueError):
        K.attention_plan(100, nk, d, chunk_tiles=K.ATT_CH16)
    with pytest.raises(ValueError):
        K.attention_bwd_plan(nk, 100, d, chunk_tiles=K.ATT_CH16)


@pytest.mark.parametrize("n", [273, 325, 1370])
def test_vit_plan_above_272_tokens_streams(n):
    """vit_qkv_kernel stays (row by row); the rest of the half is the
    streaming attention, forced long, and the GEMM."""
    plan = K.vit_attn_plan(120, n, 384, 6)
    assert plan["long"] and plan["qkv_tiles"] == -(-(120 * n) // 128)
    assert plan["attention"] == K.attention_plan(n, n, 64, long=True)
    assert plan["attention"] == {
        "long": True, "q_split": -(-n // 128), "warps": 12, "one_pass": True,
        "smem_bytes": _stream_smem(64), "key_tiles": -(-n // 128),
        "stages": 4}
    with pytest.raises(ValueError):
        K.vit_attn_plan(1, n, 768, 12)


STAGE3 = dict(learn_skeleton=True, attn_bias=True, use_flash=True)


@pytest.mark.parametrize("size", [256, 336, 448, 518])
def test_width_misfits_take_the_larger_images(size):
    """The stage-3 model at 256 (the demo's), 336, 448 and 518 px (DINOv2's
    37 x 37 grid) is taken by every fused op; d_model 128 is still refused
    by the post-attention ops alone."""
    cfg = ModelConfig(**STAGE3, image_size=size)
    assert all(why is None for why in K.width_misfits(cfg).values())
    narrow = dataclasses.replace(cfg, d_model=128, nhead=4, num_feats=64,
                                 similarity_proj_dim=128)
    out = K.width_misfits(narrow)
    refused = {op for op, why in out.items() if why is not None}
    assert refused == {"fused_encoder_stack", "fused_decoder_layer",
                       "fused_decoder_stack"}
    assert all("256 channels, got 128" in out[op] for op in refused)


@pytest.mark.parametrize("grid", [37, 16, 32])
def test_position_grid_matches_jax(grid):
    """The position grid from DINOv2's 37 x 37 pretraining grid: the
    identity at 518 px (37 x 14), bicubic elsewhere, equal to the JAX
    package's resize_pos_embed."""
    pos = np.random.default_rng(grid).normal(size=(1, 1 + 37 * 37, 8)).astype(
        np.float32)
    got = tconvert.resize_pos_embed(torch.from_numpy(pos), 37, (grid, grid))
    want = jdinov2.resize_pos_embed(pos, 37, (grid, grid))
    np.testing.assert_array_equal(got.numpy(), want)
    if grid == 37:
        np.testing.assert_array_equal(got.numpy(), pos)


# ------------------------------------------------------------- emulation
def _bf(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _scores2(q, k, scale, kb, bias):
    """Finished scores in base 2, as attn_scores forms them: log2(e) *
    (q.k^T * scale) + (log2(e) * bias + key mask), [Nq, Nk] fp32."""
    sc2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    add = kb[None, :].expand(q.shape[0], -1)
    if bias is not None:
        add = bias * LOG2E + add
    return (q @ k.T) * sc2 + add


def _pad_keys(s2, fill=-math.inf):
    """Scores padded to a whole number of register chunks."""
    nk = s2.shape[1]
    pad = -(-nk // CHUNK) * CHUNK - nk
    return torch.nn.functional.pad(s2, (0, pad), value=fill)


def _chunks(nkp, tile):
    """The register chunks in the order a block meets them: key tiles of
    `tile` keys through the ring, chunks of CHUNK keys inside each."""
    assert tile % CHUNK == 0
    for t0 in range(0, nkp, tile):
        for c in range(t0, min(t0 + tile, nkp), CHUNK):
            yield c


def _pass1(s2, tile):
    """Each row's max (base 2) and exp-sum: per-lane running values over
    the chunks in the kernel's order (lane t holds keys 4t .. 4t + 3 of
    each 16-key block), then the quad's join."""
    s2 = _pad_keys(s2)
    nq = s2.shape[0]
    m = torch.full((nq, 4), -math.inf)
    l = torch.zeros((nq, 4))
    for c in _chunks(s2.shape[1], tile):
        ch = s2[:, c:c + CHUNK].reshape(nq, 2, 4, 4)     # block, lane, key
        cm = torch.maximum(m, ch.amax(dim=(1, 3)))
        z = torch.where(cm == -math.inf, torch.zeros_like(cm), cm)
        ex = torch.exp2(ch - z[:, None, :, None])
        a = ex[:, 0, :, 0] + ex[:, 0, :, 1]
        a = a + (ex[:, 0, :, 2] + ex[:, 0, :, 3])
        a = a + (ex[:, 1, :, 0] + ex[:, 1, :, 1])
        a = a + (ex[:, 1, :, 2] + ex[:, 1, :, 3])
        l = l * torch.exp2(m - z) + a
        m = cm
    f = m.amax(dim=1)
    fz = torch.where(f == -math.inf, torch.zeros_like(f), f)
    lt = l * torch.exp2(m - fz[:, None])
    return f, (lt[:, 0] + lt[:, 1]) + (lt[:, 2] + lt[:, 3])


def _pv(p, v, tile):
    """P.V in fp32, 16 keys at a time in the chunk order."""
    nkp = p.shape[1]
    vp = torch.nn.functional.pad(v, (0, 0, 0, nkp - v.shape[0]))
    o = torch.zeros((p.shape[0], v.shape[1]))
    for c in _chunks(nkp, tile):
        for b0 in (c, c + 16):
            o = o + _bf(p[:, b0:b0 + 16]) @ vp[b0:b0 + 16]
    return o


def emulate_forward(q, k, v, *, scale, kb, bias=None, tile=64):
    """train_fwd_long_kernel at rate 0 for one head (the two-pass form):
    (probabilities before their bf16 rounding [Nq, Nk_padded], output
    fp32, row max in base e, reciprocal exp-sum)."""
    s2 = _scores2(q, k, scale, kb, bias)
    m, total = _pass1(s2, tile)
    z = torch.where(m == -math.inf, torch.zeros_like(m), m)
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
    p = torch.exp2(_pad_keys(s2) - z[:, None]) * inv[:, None]
    return p, _pv(p, v, tile), m * LN2, inv


KEY_TILE = 128      # keys of attn_long_kernel's streamed tile


def emulate_forward_online(q, k, v, *, scale, kb, bias=None):
    """attn_long_kernel for one head: one pass over key tiles of KEY_TILE
    in order; a row's running max (base 2) and its quad's four running
    sums (lane t adds keys 8 J + 2 t and + 1 of a tile, J in order); p =
    2^(s - running max), rounded to bf16 for P.V; the output and the sums
    rescaled by 2^(old max - new max); the sums joined over the quad, the
    output multiplied by the reciprocal and rounded to bf16 once (the
    kernel fuses the scale into the exponent's fma on unmasked tiles: the
    same up to fp32 rounding). Returns [Nq, D] fp32 holding bf16 values
    (0 for a fully masked row)."""
    s2 = _scores2(q, k, scale, kb, bias)
    nq, nk = s2.shape
    m = torch.full((nq,), -math.inf)
    lanes = torch.zeros((nq, 4))
    o = torch.zeros((nq, v.shape[1]))
    for t0 in range(0, nk, KEY_TILE):
        pad = KEY_TILE - min(KEY_TILE, nk - t0)
        st = torch.nn.functional.pad(s2[:, t0:t0 + KEY_TILE], (0, pad),
                                     value=-math.inf)
        vt = torch.nn.functional.pad(v[t0:t0 + KEY_TILE], (0, 0, 0, pad))
        mn = torch.maximum(m, st.amax(dim=1))
        z = torch.where(mn == -math.inf, torch.zeros_like(mn), mn)
        a = torch.exp2(m - z)
        p = torch.exp2(st - z[:, None])
        by_lane = p.reshape(nq, KEY_TILE // 8, 4, 2)     # J, lane, key
        part = torch.zeros((nq, 4))
        for j in range(KEY_TILE // 8):
            part = part + by_lane[:, j, :, 0]
            part = part + by_lane[:, j, :, 1]
        lanes = lanes * a[:, None] + part
        o = o * a[:, None] + _bf(p) @ vt
        m = mn
    total = (lanes[:, 0] + lanes[:, 1]) + (lanes[:, 2] + lanes[:, 3])
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
    return _bf(o * inv[:, None])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("nk", [600, 1469])
@pytest.mark.parametrize("d", [32, 64])
def test_online_forward_emulation_matches_plain_and_jax(d, nk, masked):
    """attn_long_kernel's one-pass order against the plain attention and
    JAX flash_mha in interpret mode (both normalise p before its bf16
    rounding, the kernel rounds the unnormalised p and divides at the
    end): the outputs within one bf16 ulp of the largest (a probability
    whose unnormalised and normalised values round differently moves an
    output across a rounding boundary: measured exactly one such ulp,
    from an output in the top binade) and 3e-4 on the mean (about a third
    of the outputs round the other way, each by an ulp of its own size:
    measured 1.5e-4)."""
    nq, h = 40, 2
    q, k, v, valid = _operands(nk + d + masked, nq, nk, h, d, masked)
    kb = plain.key_bias(torch.from_numpy(valid))[0]
    scale = 1.0 / math.sqrt(d)
    emu = torch.stack([emulate_forward_online(
        _head(q, i), _head(k, i), _head(v, i), scale=scale, kb=kb)
        for i in range(h)], dim=1)[None]                   # [1, Nq, H, D]
    flat = [torch.from_numpy(t).reshape(1, t.shape[1], h * d)
            for t in (q, k, v)]
    ref = plain.attention(*flat, num_heads=h, scale=scale,
                          kb=plain.key_bias(torch.from_numpy(valid)))
    jout = np.asarray(jflash.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(valid),
                                       interpret=True), np.float32)
    for want in (ref.reshape(emu.shape), torch.from_numpy(jout)):
        diff = (emu - want).abs()
        top = want.abs().max().item()
        assert diff.max().item() <= 2.0 ** (math.floor(math.log2(top)) - 7)
        assert diff.mean().item() <= 3e-4


def test_online_forward_fully_masked_row_is_zero():
    """A row whose keys are all masked: max -inf throughout, every p 0,
    the sum 0, the output 0 (the kernel's reciprocal of a zero sum is 0);
    its neighbours are untouched."""
    nq, nk, d = 8, 300, 32
    q, k, v, _ = _operands(11, nq, nk, 1, d, masked=False)
    kb = torch.full((nk,), -math.inf)
    out = emulate_forward_online(_head(q, 0), _head(k, 0), _head(v, 0),
                                 scale=d ** -0.5, kb=kb)
    assert torch.equal(out, torch.zeros_like(out))
    bias = torch.zeros(nq, nk)
    bias[3] = -math.inf                  # one row masked by its bias alone
    open_kb = torch.zeros(nk)
    out = emulate_forward_online(_head(q, 0), _head(k, 0), _head(v, 0),
                                 scale=d ** -0.5, kb=open_kb, bias=bias)
    assert torch.equal(out[3], torch.zeros(d))
    want = emulate_forward_online(_head(q, 0), _head(k, 0), _head(v, 0),
                                  scale=d ** -0.5, kb=open_kb)
    rows = [r for r in range(nq) if r != 3]
    assert torch.equal(out[rows], want[rows])


def emulate_backward(q, k, v, do, m, inv, *, scale, kb, bias=None, tile=64):
    """train_bwd_q_long_kernel then train_bwd_k_long_kernel at rate 0 for
    one head: (dq, dk, dv, dbias). The query-major kernel streams the keys
    (pass 1 delta, pass 2 ds, dbias, dq), the key-major one the queries."""
    nq, nk = q.shape[0], k.shape[0]
    s2 = _scores2(q, k, scale, kb, bias)
    z = m * LOG2E
    z = torch.where(z == -math.inf, torch.zeros_like(z), z)
    p = torch.exp2(s2 - z[:, None]) * inv[:, None]
    dp = do @ v.T
    delta = torch.zeros(nq)
    for t0 in range(0, nk, tile):
        delta = delta + (p[:, t0:t0 + tile] * dp[:, t0:t0 + tile]).sum(1)
    ds = p * (dp - delta[:, None])
    dq = torch.zeros_like(q)
    for t0 in range(0, nk, tile):
        dq = dq + _bf(ds[:, t0:t0 + tile]) @ k[t0:t0 + tile]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for t0 in range(0, nq, tile):
        rows = slice(t0, t0 + tile)
        dv = dv + _bf(p[rows]).T @ do[rows]
        dk = dk + _bf(ds[rows]).T @ q[rows]
    return dq * scale, dk * scale, dv, ds


def _operands(seed, nq, nk, h, d, masked=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, nq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, nk, h, d)).astype(np.float32)
            for _ in range(2))
    valid = np.ones((1, nk), bool)
    if masked:
        valid = rng.uniform(size=(1, nk)) > 0.3
        valid[:, 0] = True
    return q, k, v, valid


def _head(t, i):
    """Head i of a [1, N, H, D] array as bf16-rounded fp32 [N, D]."""
    return _bf(torch.from_numpy(np.ascontiguousarray(t[0, :, i])))


@pytest.mark.parametrize("nk", [600, 1469])
@pytest.mark.parametrize("d", [32, 64])
def test_forward_emulation_matches_plain_and_jax(nk, d):
    nq, h = 40, 2
    q, k, v, valid = _operands(nk + d, nq, nk, h, d)
    kb = plain.key_bias(torch.from_numpy(valid))[0]
    scale = 1.0 / math.sqrt(d)
    outs, probs = [], []
    for i in range(h):
        p, o, _, _ = emulate_forward(_head(q, i), _head(k, i), _head(v, i),
                                     scale=scale, kb=kb)
        probs.append(p[:, :nk])
        outs.append(_bf(o))
        # tile 32 and 128 against 64: the same chunks in the same order
        for tile in (32, 128):
            p2, o2, _, _ = emulate_forward(_head(q, i), _head(k, i),
                                           _head(v, i), scale=scale, kb=kb,
                                           tile=tile)
            assert torch.equal(p2, p) and torch.equal(o2, o)
    emu = torch.stack(outs, dim=1)[None]                # [1, Nq, H, D]
    # the plain version: fp32 softmax, the same rounding points
    flat = [torch.from_numpy(t).reshape(1, t.shape[1], h * d)
            for t in (q, k, v)]
    ref = plain.attention(*flat, num_heads=h, scale=scale,
                          kb=plain.key_bias(torch.from_numpy(valid)))
    qh = _bf(flat[0]).reshape(1, nq, h, d).transpose(1, 2)
    kh = _bf(flat[1]).reshape(1, nk, h, d).transpose(1, 2)
    soft = torch.softmax(qh @ kh.transpose(-1, -2) * scale
                         + kb[None, None, None, :], dim=-1)[0]
    assert (torch.stack(probs) - soft).abs().max().item() <= 1e-7
    # the TPU kernel in interpret mode
    jout = np.asarray(jflash.flash_mha(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(valid),
                                       interpret=True), np.float32)
    for want in (ref.reshape(emu.shape), torch.from_numpy(jout)):
        diff = (emu - want).abs()
        assert diff.max().item() <= 2 ** -8 * want.abs().max().item()
        assert diff.mean().item() <= 1e-5


def test_training_emulation_matches_jax_pair():
    """The training forward's statistics against fp64, its output and the
    backward's gradients (with a bias) against _flash_train_fwd /
    _flash_train_bwd in interpret mode, rate 0, 600 tokens."""
    n, h, d = 600, 2, 32
    q, k, v, valid = _operands(3, n, n, h, d)
    rng = np.random.default_rng(4)
    bias = (0.3 * rng.normal(size=(1, h, n, n))).astype(np.float32)
    g = rng.normal(size=(1, n, h, d)).astype(np.float32)
    kb = plain.key_bias(torch.from_numpy(valid))[0]
    scale = 1.0 / math.sqrt(d)
    jargs = [jnp.asarray(t) for t in (q, k, v)]
    seed = jnp.zeros((1,), jnp.int32)
    jout, res = jflash._flash_train_fwd(*jargs, jnp.asarray(valid),
                                        jnp.asarray(bias), seed, 0.0, True,
                                        True)
    jgrads = jflash._flash_train_bwd(0.0, True, True, res, jnp.asarray(g))
    jgrads = [np.asarray(x, np.float32) for x in
              (jgrads[0], jgrads[1], jgrads[2], jgrads[4])]
    tol = dict(atol=5e-4, rtol=0)
    for i in range(h):
        qi, ki, vi = _head(q, i), _head(k, i), _head(v, i)
        bi = torch.from_numpy(bias[0, i])
        _, o, m, inv = emulate_forward(qi, ki, vi, scale=scale, kb=kb,
                                       bias=bi)
        # statistics: the row max (base e) and 1 / exp-sum in fp64
        s = (qi.double() @ ki.double().T) * scale + kb.double() \
            + bi.double()
        m64 = s.amax(dim=1)
        inv64 = 1.0 / torch.exp(s - m64[:, None]).sum(dim=1)
        np.testing.assert_allclose(m.numpy(), m64.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(inv.numpy(), inv64.numpy(), rtol=1e-6)
        np.testing.assert_allclose(o.numpy(), np.asarray(jout)[0, :, i],
                                   **tol)
        doi = _bf(torch.from_numpy(np.ascontiguousarray(g[0, :, i])))
        dq, dk, dv, ds = emulate_backward(qi, ki, vi, doi, m, inv,
                                          scale=scale, kb=kb, bias=bi)
        for name, got, want in (("dq", dq, jgrads[0][0, :, i]),
                                ("dk", dk, jgrads[1][0, :, i]),
                                ("dv", dv, jgrads[2][0, :, i])):
            np.testing.assert_allclose(got.numpy(), want, err_msg=name,
                                       **tol)
        np.testing.assert_allclose(ds.numpy(), jgrads[3][0, i], atol=1e-5,
                                   rtol=0, err_msg="dbias")


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("n", [512, 520])
def test_training_rows_above_512_take_the_fp32_plain_path(n, monkeypatch):
    """The port's MultiHeadAttention in training (use_flash, dropout 0)
    routes as the JAX module (edgecape_tpu/models/transformer.py: the
    kernel up to 512 tokens, the fp32 einsum / softmax path above):
    flash_mha_train is taken at 512 and, patched to raise, never reached
    at 520. Output and gradients (input and every weight) against the JAX
    module with train=True: at 520 both are the fp32 plain path, held to
    1e-5 relative and 2e-5 absolute (fp32 sums in another order, the
    weights' gradients over 520 rows; measured 5.7e-6 absolute on values
    of order 1-10); at 512 both take their bf16 kernel (the port's plain
    version on the CPU, the Pallas kernel in interpret mode), held to the
    JAX package's own bounds for it, 0.02 forward and 0.05 gradients."""
    e, h = 64, 2
    rng = np.random.default_rng(n)

    def dense(i, o):
        return {"kernel": (rng.normal(size=(i, o)) / math.sqrt(i)).astype(
            np.float32), "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}

    tree = {name: dense(e, e) for name in ("q_proj", "k_proj", "v_proj",
                                           "out_proj")}
    x = rng.normal(size=(1, n, e)).astype(np.float32)
    g = rng.normal(size=(1, n, e)).astype(np.float32)
    valid = rng.uniform(size=(1, n)) > 0.2
    valid[:, 0] = True

    jm = jtransformer.MultiHeadAttention(embed_dim=e, num_heads=h,
                                         dropout=0.0, use_flash=True)

    def jloss(params, xj):
        out = jm.apply({"params": params}, xj, xj, xj,
                       key_valid=jnp.asarray(valid), train=True)
        return jnp.sum(out * g), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))

    tm = ttransformer.MultiHeadAttention(e, h, use_flash=True, dropout=0.0)
    tm.load_state_dict(tconvert.state_from_flax(tree))
    tm.train()
    taken = []
    kernel = ttransformer.flash_mha_train

    def spy(*args, **kw):
        if n > 512:
            raise AssertionError("flash_mha_train above 512 tokens")
        taken.append(n)
        return kernel(*args, **kw)

    monkeypatch.setattr(ttransformer, "flash_mha_train", spy)
    xt = torch.tensor(x, requires_grad=True)
    out = tm(xt, xt, xt, key_valid=torch.from_numpy(valid))
    (out * torch.from_numpy(g)).sum().backward()
    assert taken == ([n] if n <= 512 else [])
    tol = (dict(rtol=1e-5, atol=2e-5) if n > 512
           else dict(rtol=0.02, atol=0.02))
    gtol = tol if n > 512 else dict(rtol=0.05, atol=0.05)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **gtol)
    for name, mod in (("q_proj", tm.q_proj), ("k_proj", tm.k_proj),
                      ("v_proj", tm.v_proj), ("out_proj", tm.out_proj)):
        np.testing.assert_allclose(mod.weight.grad.numpy(),
                                   np.asarray(jgp[name]["kernel"]).T,
                                   err_msg=name, **gtol)
        np.testing.assert_allclose(mod.bias.grad.numpy(),
                                   np.asarray(jgp[name]["bias"]),
                                   err_msg=name, **gtol)
