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
train_fwd_long_kernel is the same pass with an fp32 output and the rows'
statistics (emulate_forward_online with `train`). The streaming backward
pair's emulation (emulate_backward) keeps its order: delta =
rowsum(bf16(do) * O) up front from the forward's fp32 output, then the
query-major kernel's 64-key tiles (p from the statistics, ds = p (dp -
delta), dq += bf16(ds) K a tile at a time in fp32) and the key-major
kernel's 64-query tiles (dv += bf16(p)^T do, dk += bf16(ds)^T q). The
resident kernels' two-pass form (emulate_forward: 32-key chunks of a
warp's scores, per-lane running max and exp-sum over them, a lane holding
four neighbouring keys of each 16-key block, joined over the quad; a
second pass that normalises by the final sum before the bf16 rounding of
the probabilities and adds P.V 16 keys at a time in fp32) is held at the
lengths they take. Tolerances:

* the one-pass emulations against the plain attention and JAX flash_mha /
  _flash_train_fwd in interpret mode: see
  test_online_forward_emulation_matches_plain_and_jax and
  test_forward_emulation_matches_plain_and_jax (another rounding point of
  p: one bf16 ulp of the largest output);
* the two-pass emulation against the plain attention and against JAX
  flash_mha in interpret mode (the same bf16 operands and rounding
  points, softmax summed in another order): the probabilities before
  their rounding within 1e-7 of torch's fp32 softmax (fp32 rounding of
  values <= 1; measured 1.5e-8), the outputs within one bf16 ulp of the
  largest (a probability whose fp32 value lies on a bf16 rounding
  boundary may round the other way; measured a quarter of it) and 1e-5
  on the mean (measured 1.6e-7);
* the training forward's statistics against fp64: 1e-6 relative
  (measured 5e-7); the backward's dq, dk, dv and dbias against the plain
  version's autograd and the JAX pair in interpret mode: 1e-2 + 2^-6
  |ref|, the bound the card's checks hold the kernels to (another delta
  and rounding point of p);
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
from edgecape_tpu_torch.ops import flash_attention as FA
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
    # head dim 128 (and 96, run at 128) up to the resident kernel's 416 keys
    ((100, 416, 128, False, None), {'q_split': 7, 'warps': 1, 'one_pass': False, 'smem_bytes': 232320, 'key_tiles': 26, 'chunk_tiles': 2}),  # noqa: E501
    ((356, 356, 128, False, None), {'q_split': 6, 'warps': 4, 'one_pass': False, 'smem_bytes': 219072, 'key_tiles': 23, 'chunk_tiles': 2}),  # noqa: E501
    ((100, 100, 128, False, None), {'q_split': 2, 'warps': 4, 'one_pass': True, 'smem_bytes': 78784, 'key_tiles': 7, 'chunk_tiles': 8}),  # noqa: E501
    ((257, 257, 128, True, None), {'q_split': 5, 'warps': 4, 'one_pass': False, 'smem_bytes': 166464, 'key_tiles': 17, 'chunk_tiles': 2}),  # noqa: E501
    ((100, 256, 96, False, None), {'q_split': 2, 'warps': 4, 'one_pass': False, 'smem_bytes': 157696, 'key_tiles': 16, 'chunk_tiles': 2, 'd_pad': 128}),  # noqa: E501
]
BWD_PLANS = [
    ((356, 356, 32, None), {'q_split': 3, 'q_warps': 8, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 80832, 'k_split': 3, 'k_warps': 8, 'k_smem_bytes': 85248, 'q_tiles': 23, 'key_tiles': 23}),  # noqa: E501
    ((100, 100, 32, None), {'q_split': 2, 'q_warps': 4, 'one_pass': True, 'chunk_tiles': 8, 'q_smem_bytes': 28608, 'k_split': 2, 'k_warps': 4, 'k_smem_bytes': 29952, 'q_tiles': 7, 'key_tiles': 7}),  # noqa: E501
    ((257, 257, 64, None), {'q_split': 3, 'q_warps': 6, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 107072, 'k_split': 3, 'k_warps': 6, 'k_smem_bytes': 110336, 'q_tiles': 17, 'key_tiles': 17}),  # noqa: E501
    ((512, 512, 64, None), {'q_split': 4, 'q_warps': 8, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 186368, 'k_split': 4, 'k_warps': 8, 'k_smem_bytes': 192512, 'q_tiles': 32, 'key_tiles': 32}),  # noqa: E501
    ((100, 100, 32, 2), {'q_split': 2, 'q_warps': 4, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 28608, 'k_split': 2, 'k_warps': 4, 'k_smem_bytes': 29952, 'q_tiles': 7, 'key_tiles': 7}),  # noqa: E501
    ((1, 512, 32, None), {'q_split': 1, 'q_warps': 1, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 86528, 'k_split': 8, 'k_warps': 4, 'k_smem_bytes': 13056, 'q_tiles': 1, 'key_tiles': 32}),  # noqa: E501
    ((356, 356, 128, None), {'q_split': 8, 'q_warps': 3, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 227776, 'k_split': 8, 'k_warps': 3, 'k_smem_bytes': 232192, 'q_tiles': 23, 'key_tiles': 23}),  # noqa: E501
    ((100, 100, 128, None), {'q_split': 2, 'q_warps': 4, 'one_pass': True, 'chunk_tiles': 8, 'q_smem_bytes': 96192, 'k_split': 2, 'k_warps': 4, 'k_smem_bytes': 97536, 'q_tiles': 7, 'key_tiles': 7}),  # noqa: E501
    ((300, 300, 96, None), {'q_split': 3, 'q_warps': 7, 'one_pass': False, 'chunk_tiles': 2, 'q_smem_bytes': 227520, 'k_split': 3, 'k_warps': 7, 'k_smem_bytes': 231168, 'q_tiles': 19, 'key_tiles': 19, 'd_pad': 128}),  # noqa: E501
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
    # no plan up to the caps streams (at head dim 128: 416 keys forward)
    for nk in (1, 17, 128, 129, 356, 511, 512):
        assert "long" not in K.attention_plan(100, nk, 32)
        assert "long" not in K.attention_bwd_plan(nk, nk, 32)
    for nk in (1, 129, 356, 416):
        assert "long" not in K.attention_plan(100, nk, 128)
    for n in (1, 257, 272):
        assert "long" not in K.vit_attn_plan(2, n, 384, 6)


def _bwd_smem(d):
    """The shared memory the streaming backward pair lays out: 1024 bytes
    to align the tiles on, two item slots (one at head dim 128, whose slot
    takes 64 KB) of two 128-row operands, a ring of four stages of two
    64-row tiles and 1024 bytes of side data (the key mask, or the
    queries' statistics), 128 bytes of barriers."""
    row, slots = 2 * d, 1 if d == 128 else 2
    return 1024 + slots * 2 * 128 * row + 4 * (2 * 64 * row + 1024) + 128


def _stream_stages(d):
    """attn_long_kernel's ring: four stages, two at head dim 128 (a stage
    of K, V and the mask takes 65 KB there)."""
    return 2 if d == 128 else 4


def _stream_smem(d):
    """The shared memory attn_long_kernel lays out: 1024 bytes to align
    the tiles on, two query slots of 128 rows, a ring of _stream_stages
    stages of a 128-key K and V tile and 1024 bytes for the key mask, 128
    bytes of barriers."""
    tile = 128 * 2 * d
    return 1024 + 2 * tile + _stream_stages(d) * (2 * tile + 1024) + 128


@pytest.mark.parametrize("nk", [513, 1025, 1369, 1469, 4096])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_long_plans_above_the_caps(nk, d):
    """Above 512 keys the streaming plans. The eval forward's
    (attn_long_kernel) and the training forward's (train_fwd_long_kernel,
    the same body): one pass, items of 128 query rows a (batch, head),
    blocks of 12 warps (two consumer warpgroups and the producer's), key
    tiles of 128 through a ring of 4 (2 at head dim 128), shared memory as
    the kernel lays it out and within the card's limit; a cross-attention
    of 100 queries too. The backward pair's: items of 128 query rows (keys
    for the key-major kernel) with 64-row tiles of the other side streamed
    through a ring of 4, blocks of 12 warps."""
    for nq in (1, 100, 128, 129, nk):
        plan = K.attention_plan(nq, nk, d)
        assert plan == {"long": True, "q_split": -(-nq // 128), "warps": 12,
                        "one_pass": True, "smem_bytes": _stream_smem(d),
                        "key_tiles": -(-nk // 128),
                        "stages": _stream_stages(d)}
        assert plan["smem_bytes"] <= SMEM_LIMIT
        assert K.attention_plan(nq, nk, d, train=True) == plan
        bwd = K.attention_bwd_plan(nq, nk, d)
        assert bwd == {"long": True, "q_split": -(-nq // 128),
                       "q_warps": 12, "one_pass": True,
                       "q_smem_bytes": _bwd_smem(d),
                       "k_split": -(-nk // 128), "k_warps": 12,
                       "k_smem_bytes": _bwd_smem(d),
                       "q_tiles": -(-nq // 64), "key_tiles": -(-nk // 64),
                       "stages": 4}
        assert bwd["q_smem_bytes"] <= SMEM_LIMIT
    # the backward streams wherever either side is past the cap
    assert K.attention_bwd_plan(nk, 100, d)["k_split"] == 1
    # the forcing argument runs them at a short shape; chunk_tiles forces
    # the resident kernels, which do not hold these rows
    assert K.attention_plan(356, 356, d, long=True) == K.attention_plan(
        356, nk, d) | {"q_split": 3, "key_tiles": 3}
    assert K.attention_plan(356, 356, d, train=True,
                            long=True) == K.attention_plan(356, 356, d,
                                                           long=True)
    assert K.attention_bwd_plan(100, 100, d, long=True)["long"]
    with pytest.raises(ValueError):
        K.attention_plan(100, nk, d, chunk_tiles=K.ATT_CH16)
    with pytest.raises(ValueError):
        K.attention_bwd_plan(nk, 100, d, chunk_tiles=K.ATT_CH16)


def test_ptxas_usage_reads_an_instance_apart(monkeypatch):
    """The ptxas report of a kernel's instance by its launch counter's name
    ("attn_long_kernel<128>"): that instance alone, not the other head
    dims' nor bias_attn_long_kernel's of the same template argument; the
    kernel's name alone reads every instance whose name holds it."""
    log = """ptxas info    : Compiling entry function '_Z16attn_long_kernelILi128EEv14CUtensorMap_stS0_S0_6AlArgs' for 'sm_90a'
ptxas info    : Used 168 registers
ptxas info    : Compiling entry function '_Z21bias_attn_long_kernelILi128ELi1ELi8EEv12BiasLongArgs' for 'sm_90a'
ptxas info    : Used 180 registers
ptxas info    : Compiling entry function '_Z23train_bwd_k_long_kernelILi128EEv14CUtensorMap_stS0_S0_S0_6BwArgs' for 'sm_90a'
ptxas info    : 388 bytes spill stores, 404 bytes spill loads
ptxas info    : Used 168 registers
ptxas info    : Compiling entry function '_Z16attn_long_kernelILi64EEv14CUtensorMap_stS0_S0_6AlArgs' for 'sm_90a'
ptxas info    : Used 168 registers"""  # noqa: E501
    monkeypatch.setattr(K, "build_logs", {"attn_long.cu": log})
    assert K.ptxas_usage("attn_long_kernel<128>") == [
        ("_Z16attn_long_kernelILi128EEv14CUtensorMap_stS0_S0_6AlArgs", 168, 0,
         0)]
    assert K.ptxas_usage("train_bwd_k_long_kernel<128>")[0][1:] == (168, 388,
                                                                     404)
    assert K.ptxas_usage("attn_long_kernel<32>") == []
    assert len(K.ptxas_usage("attn_long_kernel")) == 3


@pytest.mark.parametrize("n", [273, 325, 1370])
def test_vit_plan_above_272_tokens_streams(n):
    """vit_qkv_kernel stays (row by row); the rest of the half is the
    streaming attention, forced long, and the GEMM. A ViT-B/14 trunk (768
    channels in 12 heads) takes the wide route, its attention planned as
    `attention` plans any other (streamed above 512 keys); 1088 channels
    stay refused."""
    plan = K.vit_attn_plan(120, n, 384, 6)
    assert plan["long"] and plan["qkv_tiles"] == -(-(120 * n) // 128)
    assert plan["attention"] == K.attention_plan(n, n, 64, long=True)
    assert plan["attention"] == {
        "long": True, "q_split": -(-n // 128), "warps": 12, "one_pass": True,
        "smem_bytes": _stream_smem(64), "key_tiles": -(-n // 128),
        "stages": 4}
    wide = K.vit_attn_plan(1, n, 768, 12)
    assert wide["wide"] and wide["attention"] == K.attention_plan(n, n, 64)
    assert wide["attention"].get("long", False) == (n > K.ATT_MAX_KEYS)
    with pytest.raises(ValueError):
        K.vit_attn_plan(1, n, 1088, 17)


STAGE3 = dict(learn_skeleton=True, attn_bias=True, use_flash=True)


@pytest.mark.parametrize("size", [256, 336, 448, 518])
def test_width_misfits_take_the_larger_images(size):
    """The stage-3 model at 256 (the demo's), 336, 448 and 518 px (DINOv2's
    37 x 37 grid) is taken by every fused op, and so are d_model 128 and
    d_model 1024 in 16 heads of 64 (the split route); 1024 in 8 heads is
    refused by the decoder's ops alone, by their cross-attention's head
    dim of 256."""
    cfg = ModelConfig(**STAGE3, image_size=size)
    assert all(why is None for why in K.width_misfits(cfg).values())
    narrow = dataclasses.replace(cfg, d_model=128, nhead=4, num_feats=64,
                                 similarity_proj_dim=128)
    assert all(why is None for why in K.width_misfits(narrow).values())
    wide = dataclasses.replace(cfg, d_model=1024, nhead=16, num_feats=512,
                               similarity_proj_dim=1024)
    assert all(why is None for why in K.width_misfits(wide).values())
    out = K.width_misfits(dataclasses.replace(wide, nhead=8))
    refused = {op for op, why in out.items() if why is not None}
    assert refused == {"fused_decoder_layer", "fused_decoder_stack"}
    assert all("head dims 1..128, got 256" in out[op] for op in refused)


@pytest.mark.parametrize("c,h,f", [(256, 4, 512), (384, 8, 768),
                                   (512, 8, 1024)])
def test_width_misfits_take_head_dim_128_at_518px(c, h, f):
    """The heads whose cross-attention runs at head dim 128 (2 C / H: 128,
    96 run at 128, 128) are taken at 518 px, whose 1369 image keys the
    streaming kernels take past the resident kernel's 416; so is a trunk
    of 8 heads of 128 (1024 channels, 1370 tokens). Head dims above 128
    stay refused with the plan's reason."""
    cfg = ModelConfig(**STAGE3, image_size=518, d_model=c, nhead=h,
                      dim_feedforward=f, num_feats=c // 2,
                      similarity_proj_dim=c)
    assert all(why is None for why in K.width_misfits(cfg).values())
    plan = K.attention_plan(K.ATT_STREAM_ROWS, 37 * 37, 2 * c // h)
    assert plan["long"] and plan.get("d_pad", 128) == 128
    trunk = K.width_misfits(cfg, vit_dim=1024, vit_heads=8)
    assert trunk["fused_vit_block"] is None
    assert trunk["flash_mha (ViT)"] is None
    narrow = dataclasses.replace(cfg, nhead=h // 2)
    out = K.width_misfits(narrow)
    assert "head dims 1..128, got" in out["fused_decoder_layer"]


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
    """The resident training forward (train_fwd_kernel) at rate 0 for one
    head in its two-pass form, its 32-key chunks met `tile` keys at a
    time: (probabilities before their bf16 rounding [Nq, Nk_padded],
    output fp32, row max in base e, reciprocal exp-sum)."""
    s2 = _scores2(q, k, scale, kb, bias)
    m, total = _pass1(s2, tile)
    z = torch.where(m == -math.inf, torch.zeros_like(m), m)
    inv = torch.where(total > 0, 1.0 / total, torch.zeros_like(total))
    p = torch.exp2(_pad_keys(s2) - z[:, None]) * inv[:, None]
    return p, _pv(p, v, tile), m * LN2, inv


KEY_TILE = 128      # keys of attn_long_kernel's streamed tile


def emulate_forward_online(q, k, v, *, scale, kb, bias=None, train=False):
    """attn_long_kernel for one head: one pass over key tiles of KEY_TILE
    in order; a row's running max (base 2) and its quad's four running
    sums (lane t adds keys 8 J + 2 t and + 1 of a tile, J in order); p =
    2^(s - running max), rounded to bf16 for P.V; the output and the sums
    rescaled by 2^(old max - new max); the sums joined over the quad, the
    output multiplied by the reciprocal and rounded to bf16 once (the
    kernel fuses the scale into the exponent's fma on unmasked tiles: the
    same up to fp32 rounding). Returns [Nq, D] fp32 holding bf16 values
    (0 for a fully masked row). `train`: train_fwd_long_kernel at rate 0,
    the same pass with the output kept in fp32: (output, row max in base
    e, reciprocal sum)."""
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
    if train:
        return o * inv[:, None], m * LN2, inv
    return _bf(o * inv[:, None])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("nk", [600, 1469])
@pytest.mark.parametrize("d", [32, 64, 128])
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


BWD_TILE = 64       # keys (queries) of the backward pair's streamed tiles


def emulate_backward(q, k, v, do, o, m, inv, *, scale, kb, bias=None):
    """train_bwd_q_long_kernel then train_bwd_k_long_kernel at rate 0 for
    one head: (dq, dk, dv, dbias). do: bf16 values; o: the forward's fp32
    output; m, inv: its statistics. delta = rowsum(do * o) up front; p =
    2^(s log2(e) scale - max + mask + log2(e) bias) * inv from the
    statistics (no running max), ds = p (dp - delta); the query-major
    kernel adds dq += bf16(ds) K over 64-key tiles in order, the
    key-major one dv += bf16(p)^T do and dk += bf16(ds)^T q over 64-query
    tiles in order, all in fp32; dq and dk scaled once at the end."""
    nq, nk = q.shape[0], k.shape[0]
    delta = (do * o).sum(1)
    z = m * LOG2E
    z = torch.where(z == -math.inf, torch.zeros_like(z), z)
    sc2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    x = (q @ k.T) * sc2 - z[:, None] + kb[None, :]
    if bias is not None:
        x = x + bias * LOG2E
    p = torch.exp2(x) * inv[:, None]
    ds = p * (do @ v.T - delta[:, None])
    dq = torch.zeros_like(q)
    for t0 in range(0, nk, BWD_TILE):
        dq = dq + _bf(ds[:, t0:t0 + BWD_TILE]) @ k[t0:t0 + BWD_TILE]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for t0 in range(0, nq, BWD_TILE):
        rows = slice(t0, t0 + BWD_TILE)
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


def _within_a_top_ulp(got, want):
    """|got - want| within one bf16 ulp of want's largest value."""
    top = want.abs().max().item()
    diff = (got - want).abs()
    assert diff.max().item() <= 2.0 ** (math.floor(math.log2(top)) - 7)
    return diff


def _gradient_close(got, want, what):
    """The card's bound of every kernel op: 1e-2 + 2^-6 |want|."""
    want = torch.as_tensor(np.asarray(want, np.float32))
    excess = (got - want).abs() - (1e-2 + 2.0 ** -6 * want.abs())
    assert excess.max().item() <= 0, what


@pytest.mark.parametrize("nk", [600, 1469])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_forward_emulation_matches_plain_and_jax(nk, d):
    """train_fwd_long_kernel's one pass at rate 0 (emulate_forward_online
    with `train`: 128-key tiles, the unnormalised p rounded to bf16, an fp32
    output) against the plain version (flash_mha_train_plain: p
    normalised before its rounding) and JAX _flash_train_fwd in interpret
    mode: the outputs within one bf16 ulp of the largest (as attn_long_
    kernel's; measured 0.36-0.51 of it) and 3e-4 on the mean (measured
    0.9-1.4e-4); the statistics (max in base e, 1 / sum) within 1e-6 of
    fp64."""
    nq, h = 40, 2
    q, k, v, valid = _operands(nk + d, nq, nk, h, d)
    kb = plain.key_bias(torch.from_numpy(valid))[0]
    scale = 1.0 / math.sqrt(d)
    outs = []
    for i in range(h):
        qi, ki, vi = _head(q, i), _head(k, i), _head(v, i)
        o, m, inv = emulate_forward_online(qi, ki, vi, scale=scale, kb=kb,
                                           train=True)
        outs.append(o)
        s = (qi.double() @ ki.double().T) * scale + kb.double()
        m64 = s.amax(dim=1)
        np.testing.assert_allclose(m.numpy(), m64.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            inv.numpy(), (1.0 / torch.exp(s - m64[:, None]).sum(1)).numpy(),
            rtol=1e-6)
    emu = torch.stack(outs, dim=1)[None]                # [1, Nq, H, D]
    ref = flash_train_plain(q, k, v, valid)[0].detach()
    jout, _ = jflash._flash_train_fwd(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(valid), None,
        jnp.zeros((1,), jnp.int32), 0.0, False, True)
    for want in (ref, torch.from_numpy(np.asarray(jout, np.float32))):
        diff = _within_a_top_ulp(emu, want)
        assert diff.mean().item() <= 3e-4


@pytest.mark.parametrize("nk", [356, 512])
@pytest.mark.parametrize("d", [32, 64])
def test_resident_two_pass_emulation_matches_plain_and_jax(nk, d):
    """The resident kernels' two-pass form (emulate_forward) against the
    plain attention, torch's softmax and JAX flash_mha in interpret mode,
    at key counts they hold; its chunks met in tiles of 32, 64 or 128 keys
    give the same bits."""
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


def flash_train_plain(q, k, v, valid, bias=None, g=None):
    """The plain version (flash_mha_train_plain) on [1, N, H, D] numpy
    arrays: (output, and with `g` the gradients dq, dk, dv[, dbias] of
    sum(output * g))."""
    leaves = [torch.from_numpy(t).requires_grad_(g is not None)
              for t in (q, k, v)]
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_(
        g is not None)
    out = FA.flash_mha_train_plain(*leaves, torch.from_numpy(valid), bt)
    if g is None:
        return out, None
    grads = torch.autograd.grad(out, leaves + ([bt] if bt is not None
                                               else []), torch.from_numpy(g))
    return out.detach(), grads


def test_training_emulation_matches_jax_pair():
    """The training pair's one-pass order (emulate_forward_online with
    `train`, then emulate_backward: delta from the fp32 output, the
    backward kernels' 64-row tiles) at rate 0, 600 tokens, with a bias:
    the output within one bf16 ulp of the largest (measured 1.9e-3) and
    the gradients dq, dk, dv and dbias within 1e-2 + 2^-6 |ref| of the
    plain version's autograd and of _flash_train_fwd / _flash_train_bwd
    in interpret mode, the card's bound (measured 1.3e-3 on dq and dk,
    3.4e-4 on dv, 1.9e-4 on dbias: delta from the output and the
    unnormalised p's rounding move them past the two-pass order's 5e-4);
    the statistics within 1e-6 of fp64."""
    _training_pair_case(600, 32)


def test_training_emulation_matches_jax_pair_at_head_dim_128():
    """The same order, tokens and bounds at head dim 128, which the
    streaming training kernels take past what a resident block holds
    (about 400 tokens for the backward, 416 keys for the forward), but for
    the statistics: 2e-6 relative of fp64, since a score's fp32 sum of 128
    products rounds about twice as far as one of 32 (measured 1.08e-6 on
    one of the 1200 rows' 1 / sum, the rest within 1e-6)."""
    _training_pair_case(600, 128, stat_rtol=2e-6)


def _training_pair_case(n, d, stat_rtol=1e-6):
    """test_training_emulation_matches_jax_pair's check at n tokens in 2
    heads of head dim d, the statistics within stat_rtol of fp64."""
    h = 2
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
    pout, pgrads = flash_train_plain(q, k, v, valid, bias, g)
    pgrads = [x.numpy() for x in pgrads]
    for i in range(h):
        qi, ki, vi = _head(q, i), _head(k, i), _head(v, i)
        bi = torch.from_numpy(bias[0, i])
        o, m, inv = emulate_forward_online(qi, ki, vi, scale=scale, kb=kb,
                                           bias=bi, train=True)
        # statistics: the row max (base e) and 1 / exp-sum in fp64
        s = (qi.double() @ ki.double().T) * scale + kb.double() \
            + bi.double()
        m64 = s.amax(dim=1)
        inv64 = 1.0 / torch.exp(s - m64[:, None]).sum(dim=1)
        np.testing.assert_allclose(m.numpy(), m64.numpy(), rtol=stat_rtol,
                                   atol=1e-6)
        np.testing.assert_allclose(inv.numpy(), inv64.numpy(),
                                   rtol=stat_rtol)
        for want in (pout[0, :, i],
                     torch.from_numpy(np.asarray(jout, np.float32)[0, :, i])):
            _within_a_top_ulp(o, want)
        doi = _bf(torch.from_numpy(np.ascontiguousarray(g[0, :, i])))
        dq, dk, dv, ds = emulate_backward(qi, ki, vi, doi, o, m, inv,
                                          scale=scale, kb=kb, bias=bi)
        for ref, who in ((jgrads, "jax"), (pgrads, "plain")):
            for name, got, want in (("dq", dq, ref[0][0, :, i]),
                                    ("dk", dk, ref[1][0, :, i]),
                                    ("dv", dv, ref[2][0, :, i]),
                                    ("dbias", ds, ref[3][0, i])):
                _gradient_close(got, want, f"{name} against {who}")


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
