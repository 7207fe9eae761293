"""The kernel-variant ops of the port (fused_ln_mlp, fused_attn_block,
fused_vit_block2, fused_decoder_stack) through their plain PyTorch
versions (CPU tensors), against the JAX Pallas kernels in interpret mode
and the JAX reference functions; and the variant switches.

Same numpy-drawn inputs and weights on both sides. Both sides round to
bf16 at the same points, but sum in different orders, so a value can land
one bf16 ulp apart; each test states its tolerance."""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import fused_attn_block as jattn
from edgecape_tpu.ops import fused_decoder as jdec
from edgecape_tpu.ops import fused_mlp as jmlp
from edgecape_tpu.ops import fused_vit_block as jvit
from edgecape_tpu_torch.models.convert import state_from_flax
from edgecape_tpu_torch.models.dinov2 import Block, DinoV2Config
from edgecape_tpu_torch.models.transformer import (Decoder,
                                                   ensure_some_valid,
                                                   inverse_sigmoid)
from edgecape_tpu_torch.ops import fused_attn_block as tattn
from edgecape_tpu_torch.ops import fused_decoder as tdec
from edgecape_tpu_torch.ops import fused_mlp as tmlp
from edgecape_tpu_torch.ops import fused_vit_block as tvit
from edgecape_tpu_torch.ops import kernel_config

T = torch.from_numpy


def _diff(t, j):
    return np.abs(t.detach().float().numpy() - np.asarray(j, np.float32))


def _dense(rng, i, o, bias=0.1):
    return {"kernel": (rng.normal(size=(i, o)) / math.sqrt(i)).astype(
        np.float32), "bias": (rng.normal(size=o) * bias).astype(np.float32)}


def _ln(rng, c):
    return {"scale": (1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}


# ------------------------------------------------------------ fused_ln_mlp
def _mlp_args(n, c=64, f=128, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, n, c)).astype(np.float32),
            rng.normal(size=c).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            (rng.normal(size=(c, f)) / math.sqrt(c)).astype(np.float32),
            (rng.normal(size=f) * 0.1).astype(np.float32),
            (rng.normal(size=(f, c)) / math.sqrt(f)).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            np.full(c, 0.1, np.float32))


@pytest.mark.parametrize("n", [16, 21])        # aligned / not to 8 rows
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_mlp_plain_matches_jax(n, dtype):
    """Against the Pallas kernel in interpret mode: the same rounding
    points apart from the GELU (tanh there, erf here), so the bound is
    the tanh-erf gap pushed through fc2 and LayerScale, plus, for bf16
    output, one bf16 ulp of values of order 4 (2^-5). Against the fp32
    reference function (erf, no bf16 operands): the JAX package's own
    kernel-test bounds, 0.02 max and 0.002 mean, plus that ulp."""
    args = _mlp_args(n)
    x, ls = args[0], args[-1]
    jx = jnp.asarray(x).astype(dtype)
    kern = jmlp.fused_ln_mlp(jx, *map(jnp.asarray, args[1:]), interpret=True)
    ref = jmlp.reference_ln_mlp(jx, *map(jnp.asarray, args[1:]))
    tx = T(x).to(getattr(torch, dtype))
    out = tmlp.fused_ln_mlp(tx, *map(T, args[1:]))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    h = T(np.linspace(-6, 6, 4001).astype(np.float32))
    gap = float((torch.nn.functional.gelu(h, approximate="tanh")
                 - torch.nn.functional.gelu(h)).abs().max())
    w2_l1 = float(np.abs(args[5]).sum(axis=0).max())
    ulp = 2.0 ** -5 if dtype == "bfloat16" else 0.0
    assert _diff(out, kern.astype(jnp.float32)).max() \
        <= gap * w2_l1 * ls.max() + 1e-3 + ulp
    d = _diff(out, ref.astype(jnp.float32))
    assert d.max() <= 0.02 + ulp and d.mean() <= 0.002 + ulp / 8
    assert tmlp.launches == 0          # CPU tensors take the plain version


# -------------------------------------------------------- fused_attn_block
def _attn_args(b, n, c=64, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*sh, s=None):
        s = 1.0 / math.sqrt(sh[0]) if s is None else s
        return (rng.normal(size=sh) * s).astype(np.float32)

    return (rng.normal(size=(b, n, c)).astype(np.float32), mk(c, s=1.0),
            mk(c, s=0.1), mk(c, c), mk(c, s=0.1), mk(c, c), mk(c, s=0.1),
            mk(c, c), mk(c, s=0.1), mk(c, c), mk(c, s=0.1),
            np.full(c, 0.1, np.float32))


@pytest.mark.parametrize("n", [16, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attn_block_plain_matches_jax(n, dtype):
    """Against the Pallas kernel in interpret mode (the same rounding
    points): a bf16 ulp of the attention output (2^-8 on values below 1)
    through proj and LayerScale 0.1, 2e-3, plus for bf16 output one ulp of
    values of order 4 (2^-5). Against the fp32 reference function: the
    JAX package's own kernel-test bounds (0.03 max, 0.003 mean) plus that
    ulp."""
    args = _attn_args(2, n)
    jx = jnp.asarray(args[0]).astype(dtype)
    kern = jattn.fused_attn_block(jx, *map(jnp.asarray, args[1:]),
                                  num_heads=2, interpret=True)
    ref = jattn.reference_attn_block(jx, *map(jnp.asarray, args[1:]),
                                     num_heads=2)
    tx = T(args[0]).to(getattr(torch, dtype))
    out = tattn.fused_attn_block(tx, *map(T, args[1:]), num_heads=2)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    ulp = 2.0 ** -5 if dtype == "bfloat16" else 0.0
    assert _diff(out, kern.astype(jnp.float32)).max() <= 2e-3 + ulp
    d = _diff(out, ref.astype(jnp.float32))
    assert d.max() <= 0.03 + ulp and d.mean() <= 0.003 + ulp / 8
    assert tattn.launches == 0


# -------------------------------------------------------- fused_vit_block2
def _block_tree(rng, c, f):
    return {"norm1": _ln(rng, c), "norm2": _ln(rng, c),
            "ls1_gamma": np.ones(c, np.float32),
            "ls2_gamma": np.ones(c, np.float32),
            "attn": {"qkv": _dense(rng, c, 3 * c), "proj": _dense(rng, c, c)},
            "mlp_fc1": _dense(rng, c, f), "mlp_fc2": _dense(rng, f, c)}


def _block_args(tree, c):
    wqkv, bqkv = tree["attn"]["qkv"]["kernel"], tree["attn"]["qkv"]["bias"]
    return (tree["norm1"]["scale"], tree["norm1"]["bias"],
            wqkv[:, :c], bqkv[:c], wqkv[:, c:2 * c], bqkv[c:2 * c],
            wqkv[:, 2 * c:], bqkv[2 * c:], tree["attn"]["proj"]["kernel"],
            tree["attn"]["proj"]["bias"], tree["ls1_gamma"],
            tree["norm2"]["scale"], tree["norm2"]["bias"],
            tree["mlp_fc1"]["kernel"], tree["mlp_fc1"]["bias"],
            tree["mlp_fc2"]["kernel"], tree["mlp_fc2"]["bias"],
            tree["ls2_gamma"])


def _blocks(seed=0, c=128, heads=2, f=256):
    rng = np.random.default_rng(seed)
    trees = [_block_tree(rng, c, f) for _ in range(2)]
    cfg = DinoV2Config(embed_dim=c, num_heads=heads, mlp_ratio=f / c)
    blks = []
    for t in trees:
        blk = Block(cfg)
        blk.load_state_dict(state_from_flax(t))
        blks.append(blk)
    x = rng.normal(size=(2, 20, c)).astype(np.float32)
    return trees, blks, x, heads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_vit_block2_plain_bit_equal_to_two_blocks(dtype):
    _, (ba, bb), x, heads = _blocks()
    tx = T(x).to(getattr(torch, dtype))
    two = tvit.fused_vit_block(
        tvit.fused_vit_block(tx, ba, num_heads=heads), bb, num_heads=heads)
    pair = tvit.fused_vit_block2(tx, ba, bb, num_heads=heads)
    assert pair.dtype == tx.dtype
    assert torch.equal(pair, two)
    assert tvit.launches2 == 0 and tvit.launches == 0


def test_fused_vit_block2_plain_matches_jax_kernel():
    """Against the JAX fused_vit_block2 in interpret mode: the bound of
    the single block's test (a bf16 ulp of values of order 8, 0.0625, plus
    the tanh-erf GELU gap through fc2 with LayerScale 1), once per
    block."""
    trees, (ba, bb), x, heads = _blocks()
    c = x.shape[-1]
    ref = jvit.fused_vit_block2(
        jnp.asarray(x).astype(jnp.bfloat16), _block_args(trees[0], c),
        _block_args(trees[1], c), num_heads=heads, eps=1e-6, interpret=True)
    out = tvit.fused_vit_block2(T(x).to(torch.bfloat16), ba, bb,
                                num_heads=heads)
    h = T(np.linspace(-6, 6, 4001).astype(np.float32))
    gap = float((torch.nn.functional.gelu(h, approximate="tanh")
                 - torch.nn.functional.gelu(h)).abs().max())
    w2 = max(float(np.abs(t["mlp_fc2"]["kernel"]).sum(axis=0).max())
             for t in trees)
    d = _diff(out, ref.astype(jnp.float32))
    assert d.max() <= 2 * (0.0625 + gap * w2), d.max()
    assert d.mean() <= 0.02, d.mean()


# ----------------------------------------------------- fused_decoder_stack
C, HEADS, FF, KP, HW, NF, HOPS, LAYERS = 64, 2, 96, 12, 16, 32, 4, 3


def _mha(rng, e, q_dim, v_dim):
    return {"q_proj": _dense(rng, q_dim, e), "k_proj": _dense(rng, q_dim, e),
            "v_proj": _dense(rng, v_dim, e), "out_proj": _dense(rng, e, e)}


def _decoder_tree(rng, layers=LAYERS, bias=True):
    tree = {"ref_point_head": {"fc1": _dense(rng, C, C),
                               "fc2": _dense(rng, C, C)},
            "norm": _ln(rng, C)}
    for i in range(layers):
        lt = {"self_attn": _mha(rng, C, C, C), "norm1": _ln(rng, C),
              "cross_attn": _mha(rng, 2 * C, 2 * C, C),
              "choker": _dense(rng, 2 * C, C), "norm2": _ln(rng, C),
              "gcn": {"conv": _dense(rng, C, 2 * FF)},
              "ffn2": _dense(rng, FF, C), "norm3": _ln(rng, C)}
        if bias:
            lt["bias_mlp"] = {"fc1": _dense(rng, HOPS + 1, HOPS + HEADS),
                              "fc2": _dense(rng, HOPS + HEADS, HEADS)}
        tree[f"layer{i}"] = lt
        kb = {f"fc{j}": _dense(rng, C, C) for j in range(3)}
        kb["out"] = {"kernel": (rng.normal(size=(C, 2)) * 0.02).astype(
            np.float32), "bias": (rng.normal(size=2) * 0.02).astype(
            np.float32)}
        tree[f"kpt_branch{i}"] = kb
    return tree


def _decoder(tree, layers=LAYERS, bias=True, use_flash=False):
    dec = Decoder(C, HEADS, FF, layers, attn_bias=bias, max_hops=HOPS,
                  num_feats=NF, use_flash=use_flash).eval()
    dec.load_state_dict(state_from_flax(tree))
    return dec


def _decoder_inputs(rng, b=3):
    valid = rng.uniform(size=(b, KP)) > 0.3
    valid[:, 0] = True
    return dict(
        x=(rng.normal(size=(b, KP, C)) * 0.5).astype(np.float32),
        coords=rng.uniform(0.1, 0.9, size=(b, KP, 2)).astype(np.float32),
        img=(rng.normal(size=(b, HW, C)) * 0.5).astype(np.float32),
        ipos=(rng.normal(size=(HW, C)) * 0.5).astype(np.float32),
        valid=valid,
        hops=rng.uniform(0, 1, size=(b, KP, KP, HOPS + 1)).astype(np.float32),
        adj=(rng.uniform(size=(b, 2, KP, KP)) / KP).astype(np.float32))


def _jax_stack(tree, inp, layer_ids, bias):
    layer_params = tuple(
        {"dec": tree[f"layer{i}"], "kpt": tree[f"kpt_branch{i}"],
         **({"bias_mlp": tree[f"layer{i}"]["bias_mlp"]} if bias else {})}
        for i in layer_ids)
    return jdec.fused_decoder_stack(
        jnp.asarray(inp["x"]), jnp.asarray(inp["coords"]),
        jnp.asarray(inp["img"]), jnp.asarray(inp["ipos"]),
        jnp.asarray(inp["valid"]),
        jnp.asarray(inp["hops"]) if bias else None, jnp.asarray(inp["adj"]),
        layer_params, tree["ref_point_head"], tree["norm"], num_heads=HEADS,
        num_feats=NF, eps=1e-5, interpret=True)


def _torch_stack(dec, inp, bias=True, rows=slice(None)):
    return tdec.fused_decoder_stack(
        T(inp["x"])[rows], T(inp["coords"])[rows], T(inp["img"])[rows],
        T(inp["ipos"]), T(inp["valid"])[rows],
        T(inp["hops"])[rows] if bias else None, T(inp["adj"])[rows], dec,
        num_heads=HEADS, num_feats=NF)


@pytest.mark.parametrize("bias", [True, False])
def test_decoder_stack_plain_matches_jax_kernel_layer_by_layer(bias):
    """One layer at a time on the same inputs (random weights amplify an
    ulp from layer to layer): outputs and points, coordinates in [0, 1],
    to 1e-4. The delta heads have weights of 0.02, so a bf16 ulp of a
    token (2^-8 on values near 1) moves a coordinate by about 1e-5."""
    rng = np.random.default_rng(5)
    tree = _decoder_tree(rng, bias=bias)
    inp = _decoder_inputs(rng)
    for i in range(LAYERS):
        sub = {"ref_point_head": tree["ref_point_head"], "norm": tree["norm"],
               "layer0": tree[f"layer{i}"], "kpt_branch0":
               tree[f"kpt_branch{i}"]}
        dec = _decoder(sub, layers=1, bias=bias)
        jo, jp = _jax_stack(tree, inp, [i], bias)
        to, tp = _torch_stack(dec, inp, bias)
        assert to.shape == (1, 3, KP, 2) and to.dtype == torch.float32
        assert _diff(to, jo).max() <= 1e-4, (i, _diff(to, jo).max())
        assert _diff(tp, jp).max() <= 1e-4, (i, _diff(tp, jp).max())
    assert tdec.stack_launches == 0


def test_decoder_stack_plain_three_layers_track_jax_kernel():
    """The whole 3-layer stack against the JAX stack: ulp differences grow
    through the layers, so the bound is on the distribution (median 1e-4,
    99th percentile 2e-3)."""
    rng = np.random.default_rng(6)
    tree = _decoder_tree(rng)
    inp = _decoder_inputs(rng)
    jo, jp = _jax_stack(tree, inp, range(LAYERS), True)
    to, tp = _torch_stack(_decoder(tree), inp)
    for t, j in ((to, jo), (tp, jp)):
        d = _diff(t, j)
        assert np.median(d) <= 1e-4 and np.percentile(d, 99) <= 2e-3, \
            (np.median(d), d.max())


def test_decoder_stack_plain_matches_layer_chain():
    """The stack against the port's chain of fused_decoder_layer with the
    glue in PyTorch (both plain versions), within the JAX test's bounds:
    median under 1e-3, 95th percentile under 5e-3; and not bit-equal, so
    the stack route is known to have been taken."""
    rng = np.random.default_rng(7)
    tree = _decoder_tree(rng)
    inp = _decoder_inputs(rng)
    dec = _decoder(tree, use_flash=True)
    kw = dict(kp_valid=T(inp["valid"]), img_pos=T(inp["ipos"])[None].expand(
        3, -1, -1), initial_proposals=T(inp["coords"]), adj=T(inp["adj"]),
        hop_stack=T(inp["hops"]))
    with torch.no_grad():
        inter, points = dec(T(inp["x"]), T(inp["img"]), **kw)
        chain = torch.stack([
            torch.sigmoid(dec.kpt_branches[i](inter[i])
                          + inverse_sigmoid(points[i]))
            for i in range(LAYERS)])
        stack, stack_pts = dec.decode_stacked(T(inp["x"]), T(inp["img"]),
                                              **kw)
    assert len(stack_pts) == LAYERS + 1
    assert torch.equal(stack_pts[0], points[0])
    mask = inp["valid"]
    d = _diff(stack, chain.numpy())[:, mask]
    assert d.max() > 0.0
    assert np.median(d) < 1e-3 and np.quantile(d, 0.95) < 5e-3, \
        (np.median(d), np.quantile(d, 0.95))
    dp = _diff(stack_pts[-1], points[-1].numpy())[mask]
    assert np.median(dp) < 1e-3


def test_decoder_stack_rows_independent_of_batch_size():
    """Each row alone gives what it gives inside a batch of 4, to 1e-6
    (the CPU's matmul picks its blocking by shape, so the last bit may
    differ)."""
    rng = np.random.default_rng(8)
    tree = _decoder_tree(rng)
    inp = _decoder_inputs(rng, b=4)
    inp["valid"][1, 8:] = False
    inp["valid"] = ensure_some_valid(T(inp["valid"])).numpy()
    dec = _decoder(tree)
    o4, p4 = _torch_stack(dec, inp)
    for i in range(4):
        o1, p1 = _torch_stack(dec, inp, rows=slice(i, i + 1))
        np.testing.assert_allclose(o1[:, 0].numpy(), o4[:, i].numpy(),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(p1[:, 0].numpy(), p4[:, i].numpy(),
                                   atol=1e-6, rtol=0)


def test_permute_fc1_equals_jax():
    rng = np.random.default_rng(9)
    fc1 = rng.normal(size=(2 * NF, C)).astype(np.float32)   # flax [in, out]
    ref = np.asarray(jdec._permute_fc1(jnp.asarray(fc1), NF))
    out = tdec.permute_fc1(T(fc1.T.copy()), NF)             # torch [out, in]
    assert out.shape == (C, 4 * NF)
    np.testing.assert_array_equal(out.numpy().T, ref)


# ----------------------------------------------------------- kernel_config
@pytest.fixture
def clean_switches(monkeypatch, tmp_path):
    for var in ("EDGECAPE_DEC_STACK", "EDGECAPE_VIT_PAIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("EDGECAPE_TORCH_TUNED", str(tmp_path / "none.json"))
    kernel_config.set_decoder_stack(None)
    kernel_config.set_vit_pair_blocks(None)
    kernel_config.reload_tuned()
    yield tmp_path
    kernel_config.set_decoder_stack(None)
    kernel_config.set_vit_pair_blocks(None)
    monkeypatch.undo()
    kernel_config.reload_tuned()


@pytest.mark.parametrize("name,env", [
    ("decoder_stack", "EDGECAPE_DEC_STACK"),
    ("vit_pair_blocks", "EDGECAPE_VIT_PAIR")])
def test_kernel_config_precedence(clean_switches, monkeypatch, name, env):
    """override > environment > measured-defaults file > False."""
    default = getattr(kernel_config, f"{name}_default")
    setter = getattr(kernel_config, f"set_{name}")
    assert default() is False
    tuned = clean_switches / "tuned.json"
    tuned.write_text(json.dumps({"switches": {name: True}}))
    monkeypatch.setenv("EDGECAPE_TORCH_TUNED", str(tuned))
    kernel_config.reload_tuned()
    assert default() is True                      # file
    monkeypatch.setenv(env, "0")
    assert default() is False                     # environment over file
    monkeypatch.setenv(env, "1")
    assert default() is True
    setter(False)
    assert default() is False                     # override over all
    setter(None)
    assert default() is True


def test_kernel_config_ignores_the_tpu_file(clean_switches, monkeypatch):
    """pallas_tuned.json holds TPU measurements: pointing the JAX
    package's variable at a file that switches everything on changes
    nothing in the port, and the port's default path is its own file."""
    tpu = clean_switches / "pallas_tuned.json"
    tpu.write_text(json.dumps({"switches": {
        "decoder_stack": True, "vit_pair_blocks": True}}))
    monkeypatch.setenv("EDGECAPE_PALLAS_TUNED", str(tpu))
    kernel_config.reload_tuned()
    assert kernel_config.decoder_stack_default() is False
    assert kernel_config.vit_pair_blocks_default() is False
    monkeypatch.delenv("EDGECAPE_TORCH_TUNED")
    assert kernel_config.tuned_path().endswith("hopper_tuned.json")
