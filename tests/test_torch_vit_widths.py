"""The ViT trunk at widths other than ViT-S/14's 384 channels in 6 heads:
the wide route of ops/kernels.py (vit_ln_gemm_kernel of csrc/vit_wide.cu,
the attention kernels, the GEMM) that DINOv2's ViT-B/14 (768 channels, 12
heads of 64, MLP 3072) and ViT-L/14 (1024, 16 heads of 64, MLP 4096) take.

* Plans: which route a width takes (vit_attn_plan, vit_mlp_plan,
  vit_ln_gemm_plan) and what stays refused, by name: above 1024 channels,
  not a multiple of 64, heads above 128 channels, a hidden width not a
  multiple of 64.
* The width check (width_misfits): ViT-B/14 and ViT-L/14 taken at 224,
  256 and 518 px.
* The route's composition in plain PyTorch (vit_ln_gemm_plain, the
  attention's plain version, the GEMM epilogue, vit_ln_gemm_plain with
  GELU, the epilogue) against the JAX Pallas kernels in interpret mode
  (fused_vit_block, fused_ln_mlp, fused_attn_block) at both widths, with
  the bounds of the 384-channel tests (tests/test_torch_fused_ops.py,
  tests/test_torch_variant_ops.py): a bf16 ulp of the output plus the
  tanh-erf GELU gap (the TPU kernels use tanh) pushed through fc2.
* The slice at 112 px over a depth-2 ViT-B trunk: the port's fast_forward
  (plain op versions) against JAX's (interpret mode), within the bound of
  tests/test_torch_slice.py's fast-path test, and the port's estimator
  against the JAX estimator at backbone_dim 768 in fp32, within that
  file's strict tolerance (COORD_TOL, 1e-4 on normalised coordinates).

The DinoV2Configs of the two trunks are defined here: neither package has
them as constants."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.api import PoseEstimator as JaxEstimator
from edgecape_tpu.config import Config, ModelConfig as JaxModelConfig
from edgecape_tpu.config import stage3_config
from edgecape_tpu.models import dinov2 as jdinov2
from edgecape_tpu.models.edgecape import EdgeCape
from edgecape_tpu.ops import fused_attn_block as jattn
from edgecape_tpu.ops import fused_mlp as jmlp
from edgecape_tpu.ops import fused_vit_block as jvit
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.config import ModelConfig
from edgecape_tpu_torch.models import dinov2 as tdinov2
from edgecape_tpu_torch.models.convert import from_jax_params, state_from_flax
from edgecape_tpu_torch.models.edgecape import HEAD_OPS
from edgecape_tpu_torch.ops import fused_attn_block as tattn
from edgecape_tpu_torch.ops import fused_mlp as tmlp
from edgecape_tpu_torch.ops import fused_vit_block as tvit
from edgecape_tpu_torch.ops import kernel_config as KC
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import plain
from test_torch_slice import COORD_TOL, _perturb

VIT_B14 = tdinov2.DinoV2Config(embed_dim=768, depth=12, num_heads=12)
VIT_L14 = tdinov2.DinoV2Config(embed_dim=1024, depth=24, num_heads=16)
TRUNKS = {"vit-b14": VIT_B14, "vit-l14": VIT_L14}
STAGE3 = dict(learn_skeleton=True, attn_bias=True, use_flash=True)
# the bound of test_fused_vit_block_plain_matches_jax_kernel: a bf16 ulp of
# values of order 8, plus the GELU gap through fc2 (added per case)
BF16_MAX, BLOCK_MEAN = 0.0625, 0.01


def T(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _gelu_gap() -> float:
    """The largest |tanh GELU - erf GELU| (on [-6, 6])."""
    h = T(np.linspace(-6, 6, 4001))
    return float((torch.nn.functional.gelu(h, approximate="tanh")
                  - torch.nn.functional.gelu(h)).abs().max())


# ---------------------------------------------------------------- plans
@pytest.mark.parametrize("c,heads,wide,stages", [
    (384, 6, False, None), (384, 12, True, 4), (448, 7, True, 4),
    (768, 12, True, 4), (1024, 16, True, 4), (64, 1, True, 4)],
    ids=["384/6", "384/12", "448/7", "768/12", "1024/16", "64/1"])
def test_the_route_follows_the_width(c, heads, wide, stages):
    """384 channels in 6 heads keep the resident kernels (their plans as
    they were); every other width takes the wide route, whose plans hold
    vit_ln_gemm_kernel's 128-row tiles, 256-column groups, ring (as many
    48 KB stages as fit beside the bias), the producer / consumer split,
    the grid's CTAs, work units and shared memory: at the query pass the
    column split whose last round of groups ends first."""
    b, n = 510, 257
    att = K.vit_attn_plan(b, n, c, heads)
    mlp = K.vit_mlp_plan(b * n, c, 4 * c)
    if c == K.VIT_C:
        assert "wide" not in mlp and mlp["chunks"] == 4 * c // K.VIT_CHUNK
    if not wide:
        assert "wide" not in att and att["smem_bytes"] == K.VIT_ATTN_SMEM
        return
    assert att["wide"] and att["attention"] == K.attention_plan(
        n, n, c // heads)
    for plan, cols in ((att["qkv"], 3 * c), (mlp.get("fc1"), 4 * c)):
        if plan is None:                 # 384 channels: vit_mlp_kernel
            continue
        assert plan == K.vit_ln_gemm_plan(b * n, c, cols)
        assert plan["tiles"] == -(-b * n // 128) and plan["pad_rows"] == \
            plan["tiles"] * 128 - b * n
        assert plan["k_slabs"] == c // 64
        assert plan["groups"] == -(-cols // 256) and plan["stages"] == stages
        assert plan["smem_bytes"] <= 232448
        assert plan["smem_bytes"] == 1024 + stages * (49152 + 16) \
            + 4 * 8192
        assert 232448 - plan["smem_bytes"] < 49152 + 16  # as many as fit
        assert plan["ctas"] == 132
        assert (plan["threads"], plan["producer_warps"],
                plan["consumer_warpgroups"]) == (384, 1, 2)
        split = plan["column_split"]
        assert plan["units"] == plan["tiles"] * split
        assert plan["groups_per_unit"] == -(-plan["groups"] // split)
        rounds = -(-plan["units"] // 132) * plan["groups_per_unit"]
        assert rounds <= -(-plan["tiles"] // 132) * plan["groups"]


@pytest.mark.parametrize("c,cols,split", [
    (768, 2304, 9), (768, 3072, 12), (1024, 3072, 12), (1024, 4096, 16)],
    ids=["qkv-B", "fc1-B", "qkv-L", "fc1-L"])
def test_the_support_pass_splits_its_columns(c, cols, split):
    """At the support pass (34 x 257 rows: 69 tiles on 132 CTAs) whole
    tiles would leave half the card idle: the plan splits each tile's
    groups into the parts whose last round of groups ends first (the
    fewest on a tie; a part does no LayerNorm of its own). The training
    step's 65 tiles split in two: one round of units."""
    plan = K.vit_ln_gemm_plan(34 * 257, c, cols)
    assert plan["tiles"] == 69 and plan["column_split"] == split
    assert plan["units"] == 69 * split
    assert plan["groups_per_unit"] == -(-plan["groups"] // split)

    def rounds_cost(parts):
        return -(-69 * parts // 132) * -(-plan["groups"] // parts)
    assert all(rounds_cost(split) < rounds_cost(p)
               for p in range(1, plan["groups"] + 1) if p != split)
    train = K.vit_ln_gemm_plan(32 * 257, c, cols)
    assert train["tiles"] == 65 and train["column_split"] == 2
    assert train["units"] == 130 <= train["ctas"]
    assert K.vit_ln_gemm_plan(34 * 257, c, cols, ctas=66)["column_split"] \
        <= split


def test_the_wide_route_streams_long_rows():
    """At 518 px (1370 tokens) the wide route's attention is
    attn_long_kernel at head dim 64, and at head dim 128 (a trunk of 8
    heads of 128) past what the resident attention holds too."""
    plan = K.vit_attn_plan(4, 1370, 768, 12)
    assert plan["wide"] and plan["attention"]["long"]
    assert plan["attention"] == K.attention_plan(1370, 1370, 64)
    assert K.vit_attn_plan(4, 257, 1024, 8)["wide"]
    wide = K.vit_attn_plan(4, 1370, 1024, 8)
    assert wide["wide"] and wide["attention"]["long"]
    assert wide["attention"] == K.attention_plan(1370, 1370, 128)
    assert wide["attention"]["stages"] == 2


@pytest.mark.parametrize("plan,args,why", [
    ("attn", (2, 257, 1088, 17), "64..1024 channels in steps of 64, got 1088"),
    ("attn", (2, 257, 100, 4), "64..1024 channels in steps of 64, got 100"),
    ("attn", (2, 257, 1024, 4), "head dims up to 128, got 256"),
    ("attn", (2, 257, 768, 5), "768 channels do not split into 5 heads"),
    ("mlp", (300, 768, 3000), "hidden width 3000 is not a positive multiple"),
    ("mlp", (300, 1088, 4352), "64..1024 channels in steps of 64, got 1088"),
    ("ln_gemm", (300, 768, 100), "output widths in steps of 64, got 100"),
    ("ln_gemm", (0, 768, 2304), "no rows"),
], ids=["C1088", "C100", "head-dim-256", "heads-5", "F3000", "mlp-C1088",
        "N100", "no-rows"])
def test_what_the_wide_route_refuses_is_named(plan, args, why):
    fn = {"attn": K.vit_attn_plan, "mlp": K.vit_mlp_plan,
          "ln_gemm": K.vit_ln_gemm_plan}[plan]
    with pytest.raises(ValueError, match=why):
        fn(*args)


# ------------------------------------------------------------ width check
@pytest.mark.parametrize("size", [224, 256, 518])
@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_width_misfits_take_vit_b_and_l(trunk, size):
    """Every fused op takes the stage-3 model over ViT-B/14 and ViT-L/14
    (backbone_dim the trunk's width), and a model built for the card
    with the kernels on passes the build-time check at bf16 and fp32."""
    bb = TRUNKS[trunk]
    for dtype in ("bfloat16", "float32"):
        cfg = ModelConfig(**STAGE3, image_size=size,
                          backbone_dim=bb.embed_dim, compute_dtype=dtype,
                          head_dtype=dtype)
        out = tdinov2.width_misfits(cfg, bb)
        assert all(why is None for why in out.values()), out
        KC.require_widths(tdinov2.fused_ops(cfg) + HEAD_OPS, out, "cuda")


@pytest.mark.parametrize("vit,why", [
    ((1088, 17), "1088"), ((1024, 4), "head dims up to 128, got 256")],
    ids=["1088/17", "1024/4"])
def test_a_trunk_beyond_the_route_is_refused_at_build(vit, why):
    cfg = ModelConfig(**STAGE3, compute_dtype="bfloat16",
                      head_dtype="bfloat16", backbone_dim=vit[0])
    bb = tdinov2.DinoV2Config(embed_dim=vit[0], num_heads=vit[1], depth=2)
    with pytest.raises(ValueError) as err:
        KC.require_widths(tdinov2.fused_ops(cfg) + HEAD_OPS,
                          tdinov2.width_misfits(cfg, bb), "cuda")
    assert "fused_vit_block (" in str(err.value) and why in str(err.value)


# ------------------------------------------- the route against the TPU kernels
def _dense(rng, i, o):
    return {"kernel": (rng.normal(size=(i, o)) / math.sqrt(i)).astype(
        np.float32), "bias": (rng.normal(size=o) * 0.1).astype(np.float32)}


def _ln(rng, c):
    return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}


def _block_tree(rng, c, f):
    return {"norm1": _ln(rng, c), "norm2": _ln(rng, c),
            "ls1_gamma": np.ones(c, np.float32),
            "ls2_gamma": np.ones(c, np.float32),
            "attn": {"qkv": _dense(rng, c, 3 * c), "proj": _dense(rng, c, c)},
            "mlp_fc1": _dense(rng, c, f), "mlp_fc2": _dense(rng, f, c)}


def _jax_block_args(tree, c):
    wqkv, bqkv = tree["attn"]["qkv"]["kernel"], tree["attn"]["qkv"]["bias"]
    return (tree["norm1"]["scale"], tree["norm1"]["bias"],
            wqkv[:, :c], bqkv[:c], wqkv[:, c:2 * c], bqkv[c:2 * c],
            wqkv[:, 2 * c:], bqkv[2 * c:], tree["attn"]["proj"]["kernel"],
            tree["attn"]["proj"]["bias"], tree["ls1_gamma"],
            tree["norm2"]["scale"], tree["norm2"]["bias"],
            tree["mlp_fc1"]["kernel"], tree["mlp_fc1"]["bias"],
            tree["mlp_fc2"]["kernel"], tree["mlp_fc2"]["bias"],
            tree["ls2_gamma"])


def _wide_attn_half(x, w, heads, eps, out_dtype):
    """LN1 + qkv (vit_ln_gemm_plain), the attention's plain version on the
    q, k, v columns, the GEMM epilogue bf16(x) + ls1 * (att . Wp^T + bp)."""
    b, n, c = x.shape
    qkv = tvit.vit_ln_gemm_plain(x.reshape(b * n, c), w["n1w"], w["n1b"],
                                 w["wqkv"], w["bqkv"], eps=eps,
                                 round_in=True).view(b, n, 3 * c)
    att = plain.attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                          num_heads=heads, scale=(c // heads) ** -0.5)
    return (plain.bf16(x) + w["ls1"] * plain.linear(att, w["wp"], w["bp"])
            ).to(out_dtype)


def _wide_mlp_half(x, w, eps, out_dtype, b_nk=True):
    """LN2 + fc1 + GELU (vit_ln_gemm_plain), then the GEMM epilogue
    x + ls * (f . W2 + b2) with the residual as given."""
    f = tvit.vit_ln_gemm_plain(x, w["g"], w["be"], w["w1"], w["b1"], eps=eps,
                               b_nk=b_nk, gelu=True)
    w2 = w["w2"] if b_nk else w["w2"].t()
    return (x.float() + w["ls"] * plain.linear(f, w2, w["b2"])).to(out_dtype)


def _torch_block(tree, c, heads, f):
    blk = tdinov2.Block(tdinov2.DinoV2Config(embed_dim=c, num_heads=heads,
                                             mlp_ratio=f / c))
    blk.load_state_dict(state_from_flax(tree))
    return blk


@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_wide_block_matches_jax_fused_vit_block(trunk):
    """The route's five steps on [2, 17, C] against the Pallas block in
    interpret mode; the composition is also fused_vit_block_plain bit for
    bit (the plain version of both routes) and what the op runs on CPU
    tensors (no launch counted)."""
    bb = TRUNKS[trunk]
    c, heads, f = bb.embed_dim, bb.num_heads, int(bb.embed_dim * bb.mlp_ratio)
    rng = np.random.default_rng(c)
    tree = _block_tree(rng, c, f)
    blk = _torch_block(tree, c, heads, f)
    x = rng.normal(size=(2, 17, c)).astype(np.float32)
    ref = jvit.fused_vit_block(jnp.asarray(x).astype(jnp.bfloat16),
                               *_jax_block_args(tree, c), num_heads=heads,
                               eps=1e-6, interpret=True)
    w = tvit._prepare(blk)
    tx = T(x).to(torch.bfloat16)
    with torch.no_grad():
        x1 = _wide_attn_half(tx, w, heads, 1e-6, torch.float32)
        out = _wide_mlp_half(x1.view(-1, c), w, 1e-6, torch.bfloat16).view(
            tx.shape)
        assert torch.equal(out, tvit.fused_vit_block_plain(
            tx, blk, num_heads=heads))
        n0 = tvit.launches
        assert torch.equal(out, tvit.fused_vit_block(tx, blk, num_heads=heads))
        assert tvit.launches == n0 and K.launches["vit_ln_gemm_kernel"] == 0
    w2 = float(np.abs(tree["mlp_fc2"]["kernel"]).sum(axis=0).max())
    d = np.abs(out.float().numpy() - np.asarray(ref.astype(jnp.float32)))
    assert d.max() <= BF16_MAX + _gelu_gap() * w2, d.max()
    assert d.mean() <= BLOCK_MEAN, d.mean()


def _mlp_args(rng, c, f, n=21):
    return (rng.normal(size=(2, n, c)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            (rng.normal(size=(c, f)) / math.sqrt(c)).astype(np.float32),
            (rng.normal(size=f) * 0.1).astype(np.float32),
            (rng.normal(size=(f, c)) / math.sqrt(f)).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            np.full(c, 0.1, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_wide_mlp_half_matches_jax_fused_ln_mlp(trunk, dtype):
    """vit_ln_gemm_plain with GELU on the JAX layout (w1 [C, F], read with
    b_nk=False) and the epilogue, against the Pallas fused_ln_mlp in
    interpret mode: the bound of test_fused_ln_mlp_plain_matches_jax, the
    tanh-erf gap through fc2 and LayerScale plus 1e-3, plus for bf16 output
    one ulp of values of order 4 (2^-5)."""
    bb = TRUNKS[trunk]
    c, f = bb.embed_dim, int(bb.embed_dim * bb.mlp_ratio)
    args = _mlp_args(np.random.default_rng(c + 1), c, f)
    jx = jnp.asarray(args[0]).astype(dtype)
    kern = jmlp.fused_ln_mlp(jx, *map(jnp.asarray, args[1:]), interpret=True)
    tx = T(args[0]).to(getattr(torch, dtype))
    w = dict(zip(("g", "be", "w1", "b1", "w2", "b2", "ls"), map(T, args[1:])))
    out = _wide_mlp_half(tx.view(-1, c), w, 1e-6, tx.dtype,
                         b_nk=False).view(tx.shape)
    assert torch.equal(out, tmlp.fused_ln_mlp(tx, *map(T, args[1:])))
    assert tmlp.launches == 0
    ulp = 2.0 ** -5 if dtype == "bfloat16" else 0.0
    w2_l1 = float(np.abs(args[5]).sum(axis=0).max())
    d = np.abs(out.float().numpy() - np.asarray(kern.astype(jnp.float32)))
    assert d.max() <= _gelu_gap() * w2_l1 * args[-1].max() + 1e-3 + ulp, \
        d.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trunk", list(TRUNKS))
def test_wide_attn_half_matches_jax_fused_attn_block(trunk, dtype):
    """vit_ln_gemm_plain (LN1 + qkv from [wq | wk | wv]), the attention's
    plain version and the epilogue, against the Pallas fused_attn_block in
    interpret mode: the bound of test_fused_attn_block_plain_matches_jax,
    a bf16 ulp of the attention output through proj and LayerScale 0.1,
    2e-3, plus for bf16 output one ulp of values of order 4 (2^-5)."""
    bb = TRUNKS[trunk]
    c, heads = bb.embed_dim, bb.num_heads
    rng = np.random.default_rng(c + 2)

    def mk(*sh, s=None):
        s = 1.0 / math.sqrt(sh[0]) if s is None else s
        return (rng.normal(size=sh) * s).astype(np.float32)

    args = (rng.normal(size=(2, 19, c)).astype(np.float32),
            (1 + 0.1 * rng.normal(size=c)).astype(np.float32), mk(c, s=0.1),
            mk(c, c), mk(c, s=0.1), mk(c, c), mk(c, s=0.1), mk(c, c),
            mk(c, s=0.1), mk(c, c), mk(c, s=0.1), np.full(c, 0.1, np.float32))
    jx = jnp.asarray(args[0]).astype(dtype)
    kern = jattn.fused_attn_block(jx, *map(jnp.asarray, args[1:]),
                                  num_heads=heads, interpret=True)
    tx = T(args[0]).to(getattr(torch, dtype))
    w = tattn._torch_layout(*map(T, args[1:]))
    out = _wide_attn_half(tx, w, heads, 1e-6, tx.dtype)
    assert torch.equal(out, tattn.fused_attn_block(tx, *map(T, args[1:]),
                                                   num_heads=heads))
    assert tattn.launches == 0
    ulp = 2.0 ** -5 if dtype == "bfloat16" else 0.0
    d = np.abs(out.float().numpy() - np.asarray(kern.astype(jnp.float32)))
    assert d.max() <= 2e-3 + ulp, d.max()


def test_wide_wrappers_refuse_cpu_operands_and_count_nothing():
    before = dict(K.launches)
    x = torch.zeros(10, 768)
    w = torch.zeros(2304, 768, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        K.vit_ln_gemm(x, torch.ones(768), torch.zeros(768), w,
                      torch.zeros(2304), eps=1e-6)
    blk_w = tvit._prepare(tdinov2.Block(VIT_B14))
    with pytest.raises(ValueError, match="CUDA"):
        K.vit_attn_wide(x.view(2, 5, 768), blk_w, num_heads=12, eps=1e-6,
                        out_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        K.vit_mlp_wide(x, blk_w, eps=1e-6, out_dtype=torch.float32)
    assert K.launches == before


# ------------------------------------------------------------- the slice
SLICE_SIZE, SLICE_K, SLICE_HM = 112, 12, 28
JAX_B2 = jdinov2.DinoV2Config(embed_dim=768, depth=2, num_heads=12)
TORCH_B2 = tdinov2.DinoV2Config(embed_dim=768, depth=2, num_heads=12)


def _slice_cfg():
    model = JaxModelConfig(max_kpt=SLICE_K, image_size=SLICE_SIZE,
                           heatmap_size=SLICE_HM, backbone_dim=768)
    return stage3_config(Config(model=model))


def _seeded_tree(shapes, rng):
    """A parameter tree of these shapes drawn with numpy (flax's own init
    compiles for seconds): matrices at 1 / sqrt(fan-in), LayerNorm scales
    about 1, the rest (biases, tokens, embeddings) small."""
    def draw(path, leaf):
        name = str(path[-1].key)
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            x = x / math.sqrt(int(np.prod(leaf.shape[:-1])))
        elif name == "scale":
            x = 1 + 0.1 * x
        else:
            x = 0.02 * x
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def vit_b_weights():
    """(flax backbone tree, flax head tree) over a depth-2 ViT-B trunk at
    112 px in the JAX modules' shapes, drawn from a seed and perturbed as
    tests/test_torch_slice.py's."""
    rng = np.random.default_rng(3)
    m = _slice_cfg().model
    g = SLICE_SIZE // m.patch_size
    bb = _seeded_tree(jax.eval_shape(lambda: jdinov2.init_params(
        jax.random.PRNGKey(3), SLICE_SIZE, JAX_B2)), rng)
    head = _seeded_tree(jax.eval_shape(lambda: EdgeCape(m).init(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, g, g, 768)), jnp.zeros((1, 1, g, g, 768)),
        jnp.zeros((1, 1, SLICE_K, SLICE_HM, SLICE_HM)),
        jnp.zeros((1, SLICE_K)), jnp.zeros((1, SLICE_K, SLICE_K))))[
            "params"], rng)
    return _perturb(bb, head, seed=11)


def test_fast_forward_over_vit_b_matches_jax(vit_b_weights):
    """The bf16 trunk (plain op versions, erf GELU) against the JAX fast
    path (Pallas interpret, tanh GELU) over two ViT-B blocks at 112 px
    (65 tokens): the bound of test_fast_forward_plain_matches_jax_fast_
    forward, 0.0625 max and 0.005 mean on the normed features."""
    bb, _ = vit_b_weights
    vit = tdinov2.DinoViT(TORCH_B2, SLICE_SIZE)
    vit.load_state_dict(from_jax_params(bb, {})[0])
    imgs = np.random.default_rng(12).normal(
        size=(2, SLICE_SIZE, SLICE_SIZE, 3)).astype(np.float32)
    ref = jdinov2.fast_forward(jax.tree.map(jnp.asarray, bb),
                               jnp.asarray(imgs), JAX_B2, pair_blocks=False)
    with torch.no_grad():
        out = tdinov2.fast_forward(vit, torch.from_numpy(imgs),
                                   pair_blocks=False)
    assert out.shape == (2, 8, 8, 768)
    d = np.abs(out.numpy() - np.asarray(ref))
    assert d.max() <= 0.0625 and d.mean() <= 0.005, (d.max(), d.mean())


def test_forward_cached_over_vit_b_matches_jax_strict(vit_b_weights):
    """The port's PoseEstimator (fp32 plain path) over the ViT-B trunk and
    a head reading backbone_dim 768, against the JAX PoseEstimator on the
    same weights: COORD_TOL on normalised coordinates."""
    cfg = _slice_cfg()
    bb, head = vit_b_weights
    jest = JaxEstimator(cfg, backbone_params=jax.tree.map(jnp.asarray, bb),
                        head_params=jax.tree.map(jnp.asarray, head))
    jest.backbone_cfg = JAX_B2
    bb_sd, head_sd = from_jax_params(bb, head)
    test = PoseEstimator(cfg, bb_sd, head_sd,
                         device="cpu", backbone_cfg=TORCH_B2)
    rng = np.random.default_rng(13)
    adj = np.zeros((1, SLICE_K, SLICE_K), np.float32)
    for i in range(SLICE_K - 1):
        adj[:, i, i + 1] = adj[:, i + 1, i] = 1.0
    support = {"img_s": rng.integers(0, 256, (1, 1, SLICE_SIZE, SLICE_SIZE,
                                              3), dtype=np.uint8),
               "joints_s": rng.uniform(6, SLICE_SIZE - 6, (1, 1, SLICE_K, 2)
                                       ).astype(np.float32),
               "vis_s": np.ones((1, 1, SLICE_K), np.float32),
               "binary_adj": adj}
    query = {"img_q": rng.integers(0, 256, (3, SLICE_SIZE, SLICE_SIZE, 3),
                                   dtype=np.uint8),
             "group": np.zeros(3, np.int32)}
    jpred, _ = jest.forward_cached(support, query)
    tpred, _ = test.forward_cached(support, query)
    assert tpred.shape == (3, SLICE_K, 2)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
