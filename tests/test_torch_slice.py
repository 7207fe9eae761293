"""The port's cached 1-shot eval slice against the JAX package.

Weights are drawn once by the JAX package (flax init at a small trunk),
with the zero-initialised parts (KptBranch output layers, the skeleton
zero-conv, the 1e-5 LayerScale) redrawn from a numpy seed so that no
part of the forward is an identity, and mapped into the port with
convert.from_jax_params. Stage-3 flags (learned skeleton + Markov bias),
56 px, K=12, a depth-2 width-64 DINOv2 trunk.

Tolerances: fp32 against fp32 strict path, 1e-4 on normalised
coordinates and 1e-4 on the trunk's features (values of order 1; two
frameworks summing in different orders through a dozen fp32 layers)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.api import PoseEstimator as JaxEstimator
from edgecape_tpu.config import Config, DataConfig, ModelConfig, stage3_config
from edgecape_tpu.data import synthetic
from edgecape_tpu.data.mp100 import MP100Dataset
from edgecape_tpu.eval import runner as jrunner
from edgecape_tpu.models import dinov2 as jdinov2
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.eval import runner as trunner
from edgecape_tpu_torch.models import dinov2 as tdinov2
from edgecape_tpu_torch.models.convert import from_jax_params

K, SIZE, HM = 12, 56, 16
TRUNK = jdinov2.DinoV2Config(depth=2, embed_dim=64, num_heads=2)
TORCH_TRUNK = tdinov2.DinoV2Config(depth=2, embed_dim=64, num_heads=2)
COORD_TOL = 1e-4


def _cfg(use_flash=False, max_kpt=K, **model_kw):
    model = ModelConfig(max_kpt=max_kpt, image_size=SIZE, heatmap_size=HM,
                        backbone_dim=TRUNK.embed_dim, use_flash=use_flash,
                        **model_kw)
    return stage3_config(Config(model=model))


def _perturb(bb, head, seed=7):
    rng = np.random.default_rng(seed)
    bb = jax.tree.map(np.asarray, bb)
    head = jax.tree.map(np.asarray, head)
    for name, blk in bb.items():
        if name.startswith("block"):
            for ls in ("ls1_gamma", "ls2_gamma"):
                blk[ls] = (0.1 + 0.02 * rng.normal(size=blk[ls].shape)
                           ).astype(np.float32)
    for name, sub in head["decoder"].items():
        if name.startswith("kpt_branch"):
            for p in ("kernel", "bias"):
                sub["out"][p] = (rng.normal(size=sub["out"][p].shape)
                                 * 0.02).astype(np.float32)
    sk = head["skeleton"]
    sk["zero_conv_w"] = (rng.normal(size=(1,)) * 0.5).astype(np.float32)
    sk["zero_conv_b"] = (rng.normal(size=(1,)) * 0.1).astype(np.float32)
    return bb, head


@pytest.fixture(scope="module")
def weights():
    """(flax backbone tree, flax head tree) as numpy, perturbed."""
    bb = jdinov2.init_params(jax.random.PRNGKey(0), SIZE, TRUNK)
    est = JaxEstimator(_cfg(), backbone_params=bb, rng=jax.random.PRNGKey(0))
    return _perturb(bb, est.head_params)


def _jax_estimator(cfg, weights):
    bb, head = weights
    est = JaxEstimator(cfg, backbone_params=jax.tree.map(jax.numpy.asarray,
                                                         bb),
                       head_params=jax.tree.map(jax.numpy.asarray, head))
    est.backbone_cfg = TRUNK        # the small trunk the weights are for
    return est


def _torch_estimator(cfg, weights):
    bb_sd, head_sd = from_jax_params(*weights)
    return PoseEstimator(cfg, bb_sd, head_sd, device="cpu",
                         backbone_cfg=TORCH_TRUNK)


def _episodes(seed=0, g=2, q_per=3):
    rng = np.random.default_rng(seed)
    adj = np.zeros((g, K, K), np.float32)
    for i in range(K - 1):
        adj[:, i, i + 1] = adj[:, i + 1, i] = 1.0
    vis = np.ones((g, 1, K), np.float32)
    vis[0, 0, 9:] = 0.0                    # padded keypoints in group 0
    support = {
        "img_s": rng.integers(0, 256, (g, 1, SIZE, SIZE, 3), dtype=np.uint8),
        "joints_s": rng.uniform(4, SIZE - 4, (g, 1, K, 2)).astype(np.float32),
        "vis_s": vis, "binary_adj": adj}
    query = {"img_q": rng.integers(0, 256, (g * q_per, SIZE, SIZE, 3),
                                   dtype=np.uint8),
             "group": np.repeat(np.arange(g, dtype=np.int32), q_per)}
    return support, query


@pytest.mark.parametrize("use_flash", [False, True])
def test_dinovit_fp32_matches_flax(weights, use_flash):
    """fp32 trunk; with use_flash its attention is flash_mha (bf16 inside,
    JAX in interpret mode), so that case has a bf16-sized tolerance."""
    bb, _ = weights
    vit = tdinov2.DinoViT(TORCH_TRUNK, SIZE, use_flash=use_flash)
    vit.load_state_dict(from_jax_params(bb, {})[0])
    imgs = np.random.default_rng(1).normal(size=(2, SIZE, SIZE, 3)).astype(
        np.float32)
    ref = jdinov2.extract_features(jax.tree.map(jax.numpy.asarray, bb),
                                   jax.numpy.asarray(imgs), TRUNK,
                                   use_flash=use_flash)
    out = tdinov2.extract_features(vit, torch.from_numpy(imgs))
    assert out.shape == (2, SIZE // 14, SIZE // 14, TRUNK.embed_dim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=0.0625 if use_flash else 1e-4, rtol=0)


def test_fast_forward_plain_matches_jax_fast_forward(weights):
    """bf16 fused-block trunk (port: plain op versions, erf GELU) against
    the JAX fast path (Pallas interpret, tanh GELU): two blocks of bf16
    rounding plus the GELU gap, so a bf16-sized tolerance."""
    bb, _ = weights
    vit = tdinov2.DinoViT(TORCH_TRUNK, SIZE)
    vit.load_state_dict(from_jax_params(bb, {})[0])
    imgs = np.random.default_rng(2).normal(size=(2, SIZE, SIZE, 3)).astype(
        np.float32)
    ref = jdinov2.fast_forward(jax.tree.map(jax.numpy.asarray, bb),
                               jax.numpy.asarray(imgs), TRUNK,
                               pair_blocks=False)
    out = tdinov2.extract_features(vit, torch.from_numpy(imgs),
                                   dtype=torch.bfloat16, use_flash=True)
    d = np.abs(out.numpy() - np.asarray(ref))
    assert d.max() <= 0.0625 and d.mean() <= 0.005, (d.max(), d.mean())


def test_forward_cached_fp32_matches_jax_strict(weights):
    cfg = _cfg()
    support, query = _episodes()
    jpred, jadj = _jax_estimator(cfg, weights).forward_cached(support, query)
    tpred, tadj = _torch_estimator(cfg, weights).forward_cached(support,
                                                                query)
    assert tpred.dtype == torch.float32 and tpred.shape == (6, K, 2)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred),
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)


def test_forward_cached_kernel_path_on_cpu_tracks_strict(weights):
    """use_flash with bf16 compute and head dtype on CPU tensors: the
    kernel ops' plain versions carry the bf16 rounding points, so the
    predictions track the fp32 strict path to bf16-sized tolerance (a
    few hundredths on normalised coordinates; the local soft-argmax
    window can move by one 1/4 cell on a near tie, so the bound is on the
    median and the 90th percentile)."""
    support, query = _episodes(seed=3)
    strict = _torch_estimator(_cfg(), weights)
    fast = _torch_estimator(_cfg(use_flash=True, compute_dtype="bfloat16",
                                 head_dtype="bfloat16"), weights)
    p32, _ = strict.forward_cached(support, query)
    p16, _ = fast.forward_cached(support, query)
    d = np.abs(p32.numpy() - p16.numpy())
    assert np.isfinite(p16.numpy()).all()
    assert np.median(d) <= 0.02 and np.percentile(d, 90) <= 0.1, d


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp100synth_torch")
    ann = synthetic.generate(str(root), num_classes=3, images_per_class=8,
                             image_size=128, seed=0)
    dcfg = DataConfig(ann_file=ann, img_prefix=str(root / "images"),
                      num_shots=1, num_queries=3, num_episodes=2,
                      image_size=SIZE, heatmap_size=HM, max_kpt=16,
                      sigma=1.0)
    return dcfg


def test_run_eval_metrics_equal_jax(weights, synth, tmp_path):
    # the synthetic categories have up to 15 keypoints; no head parameter
    # depends on K
    cfg = dataclasses.replace(_cfg(max_kpt=16), test_data=synth)
    ds = MP100Dataset(synth, mode="test")
    jres = jrunner.run_eval(ds, _jax_estimator(cfg, weights), batch_size=6,
                            res_folder=str(tmp_path / "jax"),
                            progress=False, cache_supports=True)
    tres = trunner.run_eval(ds, _torch_estimator(cfg, weights),
                            batch_size=6, res_folder=str(tmp_path / "torch"),
                            progress=False, cache_supports=True)
    for key in ("PCK@0.05", "PCK@0.1", "PCK@0.15", "PCK@0.2", "PCK@0.25",
                "mPCK", "PCK", "AUC"):
        assert tres[key] == jres[key], key
    for key in ("NME", "EPE"):
        assert tres[key] == pytest.approx(jres[key], rel=1e-5, abs=1e-6), key
