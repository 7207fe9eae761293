"""Widths checked when a model is built (ops/kernels.py width_misfits,
ops/kernel_config.py require_widths): a model built for the card with its
fused ops on raises ValueError at build time, naming each op whose
kernels do not take its widths and the width, so that no forward pass
raises half way; use_flash=False builds the plain modules. On the CPU
nothing is checked (an op takes its plain version, which takes any
width). The head is only built here, never moved to a card. The kernels
take every head of up to 512 channels in up to 16 heads with head dims
(self- and cross-attention) up to 128, and every trunk of 64..1024
channels in steps of 64 in heads of up to 128 (ViT-S/14 on its resident
kernels, ViT-B/14 and ViT-L/14 on the wide route), and any keypoint count;
what stays refused is a wider trunk or head and larger head dims.

A port model at d_model 128 (4 heads, num_feats 64) matches the JAX model
on the same weights in fp32 on the CPU, to the strict path's tolerance of
tests/test_torch_slice.py (1e-4 on normalised coordinates), with that
file's toy trunk and configuration; so does the same model at DINOv2's own
518 px (1370 ViT tokens, 1369 + K joint-encoder keys: the rows the
streaming attention kernels take on the card), and a model at d_model 200
in 8 heads with an FFN of 300 (head dims 25 and 50, every padding the
kernels apply on the card), whose training step's gradients also match
the JAX step's to the bounds of tests/test_torch_train.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.api import PoseEstimator as JaxEstimator
from edgecape_tpu.models import dinov2 as jdinov2
from edgecape_tpu_torch.config import ModelConfig
from edgecape_tpu_torch.models.convert import state_from_flax
from edgecape_tpu_torch.models.edgecape import EdgeCape
from edgecape_tpu_torch.ops import kernel_config as KC
from edgecape_tpu_torch.ops import kernels as K
from test_torch_slice import (COORD_TOL, K as KPT, SIZE, TRUNK, _cfg,
                              _episodes, _jax_estimator, _perturb,
                              _torch_estimator)
import test_torch_train as ttrain

NARROW = dict(d_model=128, nhead=4, num_feats=64, similarity_proj_dim=128)
# every padding of the kernels: head dims 25 and 50, C and the FFN
D200 = dict(d_model=200, nhead=8, num_feats=100, dim_feedforward=300,
            similarity_proj_dim=200)
WIDE = dict(d_model=1024, nhead=8, num_feats=512, similarity_proj_dim=1024)
POST_OPS = {"fused_encoder_stack", "fused_decoder_layer",
            "fused_decoder_stack"}
DEC_OPS = {"fused_decoder_layer", "fused_decoder_stack"}
STAGE3 = dict(learn_skeleton=True, attn_bias=True, use_flash=True)


@pytest.mark.parametrize("kw,misfit", [
    ({}, set()),
    (NARROW, set()),
    (dict(d_model=192, nhead=8, num_feats=96, similarity_proj_dim=192),
     set()),
    (dict(nhead=2), DEC_OPS),
    (WIDE, DEC_OPS),
    (dict(max_kpt=160), set()),
    (dict(d_model=384, nhead=2, num_feats=192, similarity_proj_dim=384),
     POST_OPS | {"flash_mha (encoder)", "flash_mha (keypoints)"}),
], ids=["256/8", "128/4", "192/8", "256/2", "1024/8", "K160", "384/2"])
def test_width_predicate(kw, misfit):
    """All fused at the stage-3 widths and at the others the kernels take
    (d_model 128 in 4 heads, 192 in 8: head dims 32 and 24, run at 32);
    where a width stays refused, exactly the ops whose plans refuse it,
    each with the plan's reason: the cross-attention's head dim 2 x 256 /
    2 = 256 and 2 x 1024 / 8 = 256 (1024 channels themselves are taken:
    the split route), a self-attention head dim of 192; 160 keypoints are
    taken (the streaming bias attention, the cross layer's wide pair)."""
    out = K.width_misfits(ModelConfig(**STAGE3, **kw))
    assert {op for op, why in out.items() if why is not None} == misfit
    assert out["fused_vit_block"] is None and out["flash_mha (ViT)"] is None
    for op in misfit:
        assert "head dims 1..128, got" in out[op], out[op]


def test_the_vit_route_follows_the_trunk():
    """ViT-B/14 (768 channels in 12 heads) and ViT-L/14 (1024 in 16) are
    taken on the wide route; a trunk above its 1024 channels or with heads
    above 128 channels is refused; more tokens than vit_attn_kernel's
    score row holds (325 at 256 px) are taken, the attention streaming its
    keys."""
    cfg = ModelConfig(**STAGE3)
    for vit in ((768, 12), (1024, 16)):
        assert K.width_misfits(cfg, vit_dim=vit[0], vit_heads=vit[1])[
            "fused_vit_block"] is None
    assert "got 1088" in K.width_misfits(cfg, vit_dim=1088, vit_heads=17)[
        "fused_vit_block"]
    assert "head dims up to 128, got 256" in K.width_misfits(
        cfg, vit_dim=1024, vit_heads=4)["fused_vit_block"]
    big = K.width_misfits(dataclasses.replace(cfg, image_size=256))
    assert big["fused_vit_block"] is None
    assert big["flash_mha (ViT)"] is None and big["fused_encoder_stack"] \
        is None


def test_a_head_built_for_the_card_refuses_other_widths():
    """At d_model 1024 in 8 heads the decoder's two ops refuse, in one
    error raised before any module is built, by their cross-attention's
    head dim of 256; the encoder stack takes 1024 channels (the split
    route) and the attention kernels 8 heads of 128, so those ops are not
    named."""
    cfg = ModelConfig(**STAGE3, **WIDE)
    with pytest.raises(ValueError) as err:
        EdgeCape(cfg, use_flash=True, device="cuda")
    msg = str(err.value)
    for op in DEC_OPS:
        assert f"{op} (attention takes head dims 1..128, got 256)" in msg, \
            msg
    assert "fused_encoder_stack" not in msg
    assert "flash_mha" not in msg and "use_flash=False" in msg
    with pytest.raises(ValueError, match="train_backbone_fast"):
        KC.require_widths(("fused_vit_block",),
                          K.width_misfits(cfg, vit_dim=1088, vit_heads=17),
                          torch.device("cuda", 0),
                          "model.train_backbone_fast=False")


@pytest.mark.parametrize("kw,flash,device", [
    ({}, True, "cuda"), ({}, True, torch.device("cuda", 0)),
    (NARROW, True, "cpu"), (NARROW, True, None), (NARROW, False, "cuda"),
    (NARROW, True, "cuda"), (WIDE, True, "cpu"), (WIDE, False, "cuda"),
], ids=["256-cuda", "256-cuda:0", "128-cpu", "128-nodevice", "128-plain",
        "128-cuda", "1024-cpu", "1024-plain"])
def test_a_head_builds_where_its_ops_take_its_widths(kw, flash, device):
    """The stage-3 widths on the card, any width for the CPU (or with no
    device named), and any width with use_flash off: built, the fused
    route as asked."""
    head = EdgeCape(ModelConfig(**STAGE3, **kw), use_flash=flash,
                    device=device)
    assert head.use_flash is flash
    assert head.encoder_layers[0].self_attn.use_flash is flash
    assert head.decoder.use_flash is flash


@pytest.mark.parametrize("size,dtype,refused", [
    (256, "float32", None), (256, "bfloat16", None),
    (224, "float32", None), (224, "bfloat16", None),
    (224, "bfloat16", "fused_vit_block"),
])
def test_the_trunk_check_follows_the_compute_dtype(size, dtype, refused):
    """The estimator checks the trunk op its compute dtype launches: the
    fused block at bf16, flash_mha at fp32; both take 256 px (325 tokens:
    the fused block's attention streams its keys past 272). A trunk of
    1088 channels (17 heads of 64), above the wide route's 1024, is
    refused by the fused block, not by flash_mha. require_widths for
    "cuda" needs no card."""
    from edgecape_tpu_torch.models import dinov2 as tdinov2
    from edgecape_tpu_torch.models.edgecape import HEAD_OPS
    cfg = ModelConfig(**STAGE3, image_size=size, compute_dtype=dtype,
                      head_dtype=dtype)
    ops = tdinov2.fused_ops(cfg) + HEAD_OPS
    assert ops[0] == ("fused_vit_block" if dtype == "bfloat16"
                      else "flash_mha (ViT)")
    if refused is None:
        KC.require_widths(ops, tdinov2.width_misfits(cfg), "cuda")
        return
    wide = tdinov2.DinoV2Config(embed_dim=1088, num_heads=17)
    with pytest.raises(ValueError) as err:
        KC.require_widths(ops, tdinov2.width_misfits(cfg, wide), "cuda")
    msg = str(err.value)
    assert f"{refused} (" in msg and "got 1088" in msg, msg
    assert "flash_mha" not in msg, msg


@pytest.fixture(scope="module")
def narrow_weights():
    """(flax backbone tree, flax head tree) of the d_model 128 head."""
    bb = jdinov2.init_params(jax.random.PRNGKey(0), SIZE, TRUNK)
    est = JaxEstimator(_cfg(**NARROW), backbone_params=bb,
                       rng=jax.random.PRNGKey(0))
    return _perturb(bb, est.head_params)


def test_forward_cached_d_model_128_matches_jax_strict(narrow_weights):
    cfg = _cfg(**NARROW)
    support, query = _episodes()
    jpred, jadj = _jax_estimator(cfg, narrow_weights).forward_cached(
        support, query)
    tpred, tadj = _torch_estimator(cfg, narrow_weights).forward_cached(
        support, query)
    assert tpred.shape == (6, KPT, 2)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)


def test_forward_cached_at_518px_matches_jax_strict(narrow_weights):
    """The slice at 518 px: the port's PoseEstimator (plain path) against
    the JAX PoseEstimator, the trunk's position grid at 37 x 37 (the
    pretraining grid, used as it is), seeded the same for both."""
    bb, head = narrow_weights
    bb = dict(bb, pos_embed=(0.02 * np.random.default_rng(9).normal(
        size=(1, 1 + 37 * 37, TRUNK.embed_dim))).astype(np.float32))
    base = _cfg(**NARROW)
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, image_size=518))
    rng = np.random.default_rng(10)
    adj = np.zeros((1, KPT, KPT), np.float32)
    for i in range(KPT - 1):
        adj[:, i, i + 1] = adj[:, i + 1, i] = 1.0
    support = {"img_s": rng.integers(0, 256, (1, 1, 518, 518, 3),
                                     dtype=np.uint8),
               "joints_s": rng.uniform(20, 498, (1, 1, KPT, 2)).astype(
                   np.float32),
               "vis_s": np.ones((1, 1, KPT), np.float32),
               "binary_adj": adj}
    query = {"img_q": rng.integers(0, 256, (2, 518, 518, 3), dtype=np.uint8),
             "group": np.zeros(2, np.int32)}
    jpred, jadj = _jax_estimator(cfg, (bb, head)).forward_cached(support,
                                                                 query)
    tpred, tadj = _torch_estimator(cfg, (bb, head)).forward_cached(support,
                                                                   query)
    assert tpred.shape == (2, KPT, 2)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)


# a head of 128 channels in 2 heads: the decoder's cross-attention at head
# dim 128, at 308 px over 484 image keys (past the resident attention's
# 416 on the card: attn_long_kernel at head dim 128)
CROSS128 = dict(d_model=128, nhead=2, num_feats=64, similarity_proj_dim=128)
CROSS128_SIZE = 308


def test_forward_cached_at_cross_head_dim_128_matches_jax_strict():
    """The slice with the CROSS128 head at 308 px: the port's fp32
    forward_cached (plain path) against the JAX strict path on the same
    weights, to the strict path's 1e-4 on normalised coordinates; the
    width check takes the model."""
    base = _cfg(**CROSS128)
    cfg = dataclasses.replace(base, model=dataclasses.replace(
        base.model, image_size=CROSS128_SIZE))
    misfits = K.width_misfits(cfg.model, vit_heads=TRUNK.num_heads)
    assert all(why is None for why in misfits.values()), misfits
    assert K.attention_plan(KPT, 22 * 22, 128)["long"]
    bb = jdinov2.init_params(jax.random.PRNGKey(0), CROSS128_SIZE, TRUNK)
    est = JaxEstimator(cfg, backbone_params=bb, rng=jax.random.PRNGKey(2))
    weights = _perturb(bb, est.head_params, seed=11)
    rng = np.random.default_rng(308)
    n = CROSS128_SIZE
    adj = np.zeros((1, KPT, KPT), np.float32)
    for i in range(KPT - 1):
        adj[:, i, i + 1] = adj[:, i + 1, i] = 1.0
    support = {"img_s": rng.integers(0, 256, (1, 1, n, n, 3),
                                     dtype=np.uint8),
               "joints_s": rng.uniform(10, n - 10, (1, 1, KPT, 2)).astype(
                   np.float32),
               "vis_s": np.ones((1, 1, KPT), np.float32),
               "binary_adj": adj}
    query = {"img_q": rng.integers(0, 256, (2, n, n, 3), dtype=np.uint8),
             "group": np.zeros(2, np.int32)}
    jpred, jadj = _jax_estimator(cfg, weights).forward_cached(support, query)
    tpred, tadj = _torch_estimator(cfg, weights).forward_cached(support,
                                                                query)
    assert tpred.shape == (2, KPT, 2)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)


@pytest.fixture(scope="module")
def d200_weights():
    """(flax backbone tree, flax head tree) of the d_model 200 head."""
    bb = jdinov2.init_params(jax.random.PRNGKey(0), SIZE, TRUNK)
    est = JaxEstimator(_cfg(**D200), backbone_params=bb,
                       rng=jax.random.PRNGKey(1))
    return _perturb(bb, est.head_params)


def test_forward_cached_d_model_200_matches_jax_strict(d200_weights):
    cfg = _cfg(**D200)
    from edgecape_tpu_torch.models.edgecape import HEAD_OPS
    misfits = K.width_misfits(cfg.model)
    assert all(misfits[op] is None for op in HEAD_OPS), misfits
    support, query = _episodes()
    jpred, jadj = _jax_estimator(cfg, d200_weights).forward_cached(
        support, query)
    tpred, tadj = _torch_estimator(cfg, d200_weights).forward_cached(
        support, query)
    assert tpred.shape == (6, KPT, 2)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)


def test_training_step_d_model_200_matches_jax():
    """One stage-3 step at d_model 200 / 8 heads / FFN 300 (the training
    tests' toy trunk, K and batch): the loss dict and every gradient
    against the JAX step's, within tests/test_torch_train.py's bounds."""
    cfg = ttrain._cfg(3, **D200)
    weights = ttrain._weights(cfg)
    batch = ttrain._batch(seed=3)
    jm, jg = ttrain._jax_step(cfg, weights, batch)
    tm, tg = ttrain._torch_grads(cfg, weights, batch)
    jg = {n: v.numpy() for n, v in state_from_flax(jg).items()}
    assert set(tm) == set(jm) and set(tg) == set(jg)
    for key in jm:
        assert tm[key] == pytest.approx(jm[key], abs=ttrain.LOSS_TOL), key
    live = 0
    for name in sorted(jg):
        np.testing.assert_allclose(tg[name], jg[name], atol=ttrain.GRAD_ATOL,
                                   rtol=ttrain.GRAD_RTOL, err_msg=name)
        live += int(np.abs(jg[name]).max() > 1e-8)
    assert live >= 0.8 * len(jg), (live, len(jg))
