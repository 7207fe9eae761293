"""The port's uncached, debug and 5-shot eval paths and its kernel-variant
routes against the JAX package.

Weights as in test_torch_slice.py: drawn once by the JAX package at a
small trunk, the zero-initialised parts redrawn from a numpy seed, mapped
with convert.from_jax_params. Stage-3 flags, 56 px, a depth-2 width-64
trunk; episodes from the JAX package's synthetic MP-100 stand-in.

Tolerances: fp32 against the JAX strict path (use_flash=False, fp32):
1e-4 on normalised coordinates, similarity and attention maps (values of
order 1 summed in another order through a dozen fp32 layers), metrics
equal to 1e-6."""

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
from edgecape_tpu_torch import api as tapi
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.eval import runner as trunner
from edgecape_tpu_torch.models import dinov2 as tdinov2
from edgecape_tpu_torch.models.convert import from_jax_params
from edgecape_tpu_torch.ops import fused_decoder, fused_vit_block
from edgecape_tpu_torch.ops import kernel_config

K, SIZE, HM = 16, 56, 16
TRUNK = jdinov2.DinoV2Config(depth=2, embed_dim=64, num_heads=2)
TORCH_TRUNK = tdinov2.DinoV2Config(depth=2, embed_dim=64, num_heads=2)
TOL = 1e-4
METRICS = ("PCK@0.05", "PCK@0.1", "PCK@0.15", "PCK@0.2", "PCK@0.25", "mPCK",
           "PCK", "AUC", "NME", "EPE")


def _cfg(data, **model_kw):
    model = ModelConfig(max_kpt=K, image_size=SIZE, heatmap_size=HM,
                        backbone_dim=TRUNK.embed_dim, use_flash=False,
                        **model_kw)
    return dataclasses.replace(stage3_config(Config(model=model)),
                               test_data=data)


@pytest.fixture(scope="module")
def weights():
    """(flax backbone tree, flax head tree) as numpy, zero inits redrawn."""
    bb = jdinov2.init_params(jax.random.PRNGKey(0), SIZE, TRUNK)
    est = JaxEstimator(_cfg(DataConfig()), backbone_params=bb,
                       rng=jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    bb = jax.tree.map(np.asarray, bb)
    head = jax.tree.map(np.asarray, est.head_params)
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
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp100synth_paths")
    ann = synthetic.generate(str(root), num_classes=3, images_per_class=8,
                             image_size=128, seed=0)
    return ann, str(root / "images")


def _data(synth_root, shots):
    ann, prefix = synth_root
    return DataConfig(ann_file=ann, img_prefix=prefix, num_shots=shots,
                      num_queries=3, num_episodes=2, image_size=SIZE,
                      heatmap_size=HM, max_kpt=K, sigma=1.0)


def _jax_estimator(cfg, weights):
    bb, head = weights
    est = JaxEstimator(cfg, backbone_params=jax.tree.map(jax.numpy.asarray,
                                                         bb),
                       head_params=jax.tree.map(jax.numpy.asarray, head))
    est.backbone_cfg = TRUNK
    return est


def _torch_estimator(cfg, weights):
    bb_sd, head_sd = from_jax_params(*weights)
    return PoseEstimator(cfg, bb_sd, head_sd, device="cpu",
                         backbone_cfg=TORCH_TRUNK)


def _first_batch(data, n=4):
    ds = MP100Dataset(data, mode="test")
    return ds, next(iter(ds.batches(n, masking_ratio=0.0)))


@pytest.mark.parametrize("shots", [1, 5])
def test_forward_batch_matches_jax_strict(weights, synth_root, shots):
    data = _data(synth_root, shots)
    cfg = _cfg(data)
    _, batch = _first_batch(data)
    assert batch.img_s.shape[1] == shots
    jp, jadj, jtraj = _jax_estimator(cfg, weights).forward_batch(batch)
    tp, tadj, ttraj = _torch_estimator(cfg, weights).forward_batch(batch)
    layers = cfg.model.num_decoder_layers
    assert tp.dtype == torch.float32 and tp.shape == (4, K, 2)
    assert ttraj.shape == (layers + 1, 4, K, 2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=0)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)


def test_forward_debug_matches_jax(weights, synth_root):
    data = _data(synth_root, 1)
    cfg = _cfg(data)
    _, batch = _first_batch(data)
    jp, jadj, jsim, jattn = _jax_estimator(cfg, weights).forward_debug(batch)
    tp, tadj, tsim, tattn = _torch_estimator(cfg, weights).forward_debug(
        batch)
    g = SIZE // 14
    assert tsim.shape == (4, K, g, g)
    assert tattn.shape == (cfg.model.num_decoder_layers, 4, K, g * g)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tsim.numpy(), np.asarray(jsim), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tattn.numpy(), np.asarray(jattn), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tattn.sum(-1).numpy(), 1.0, atol=1e-5)


def test_forward_debug_of_a_kernel_path_estimator_runs_plain(weights,
                                                             synth_root):
    """A use_flash estimator's debug forward runs plain modules over the
    same weights: in fp32 it equals the strict estimator's to 1e-6, and it
    follows a later load_head_state."""
    data = _data(synth_root, 1)
    _, batch = _first_batch(data)
    strict = _torch_estimator(_cfg(data), weights)
    fast = _torch_estimator(
        dataclasses.replace(_cfg(data), model=dataclasses.replace(
            _cfg(data).model, use_flash=True)), weights)
    assert fast.use_flash and not fast.strict and strict.strict
    for a, b in zip(strict.forward_debug(batch), fast.forward_debug(batch)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)
    sd = {k: v * 1.01 for k, v in fast.head.state_dict().items()}
    fast.load_head_state(sd)
    strict.load_head_state(sd)
    for a, b in zip(strict.forward_debug(batch), fast.forward_debug(batch)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_decode_batch_equals_jax(weights, synth_root):
    data = _data(synth_root, 1)
    cfg = _cfg(data)
    _, batch = _first_batch(data)
    pred = np.random.default_rng(0).uniform(size=(4, K, 2)).astype(
        np.float32)
    jout = _jax_estimator(cfg, weights).decode_batch(pred, batch)
    tout = _torch_estimator(cfg, weights).decode_batch(
        torch.from_numpy(pred), batch)
    assert set(tout) == set(jout)
    np.testing.assert_allclose(tout["preds"], jout["preds"], atol=1e-4,
                               rtol=1e-6)
    np.testing.assert_array_equal(tout["boxes"], jout["boxes"])
    assert list(tout["image_paths"]) == list(jout["image_paths"])
    assert list(tout["bbox_ids"]) == list(jout["bbox_ids"])


@pytest.mark.parametrize("shots", [1, 5])
def test_uncached_run_eval_matches_jax(weights, synth_root, tmp_path, shots):
    data = _data(synth_root, shots)
    cfg = _cfg(data)
    ds = MP100Dataset(data, mode="test")
    jres = jrunner.run_eval(ds, _jax_estimator(cfg, weights), batch_size=6,
                            res_folder=str(tmp_path / "jax"), progress=False,
                            cache_supports=False)
    est = _torch_estimator(cfg, weights)
    tres = trunner.run_eval(ds, est, batch_size=6,
                            res_folder=str(tmp_path / "torch"),
                            progress=False)
    for key in METRICS:
        assert tres[key] == pytest.approx(jres[key], rel=1e-5, abs=1e-6), key
    # the cached loop of the port gives the same metrics on these episodes
    cres = trunner.run_eval(ds, est, batch_size=6,
                            res_folder=str(tmp_path / "cached"),
                            progress=False, cache_supports=True)
    for key in METRICS:
        assert cres[key] == pytest.approx(tres[key], rel=1e-4, abs=1e-5), key
    assert "dispatch_seconds" in cres and "dispatch_seconds" not in tres


def test_forward_cached_five_shot_matches_jax(weights, synth_root):
    data = _data(synth_root, 5)
    cfg = _cfg(data)
    ds = MP100Dataset(data, mode="test")
    support, query, _ = ds.collate_group(ds.support_groups()[:2])
    assert support["img_s"].shape[1] == 5
    jp, jadj = _jax_estimator(cfg, weights).forward_cached(support, query)
    tp, tadj = _torch_estimator(cfg, weights).forward_cached(support, query)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=TOL, rtol=0)
    np.testing.assert_allclose(tadj.numpy(), np.asarray(jadj), atol=1e-5,
                               rtol=0)


@pytest.fixture
def switches(monkeypatch, tmp_path):
    """The switches with no environment variable and no measured-defaults
    file behind them, so that the default is the per-layer form."""
    for var in ("EDGECAPE_DEC_STACK", "EDGECAPE_VIT_PAIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("EDGECAPE_TORCH_TUNED", str(tmp_path / "none.json"))
    kernel_config.reload_tuned()
    yield kernel_config
    kernel_config.set_decoder_stack(None)
    kernel_config.set_vit_pair_blocks(None)
    monkeypatch.undo()
    kernel_config.reload_tuned()


def test_variant_switches_route_the_kernel_path(weights, synth_root,
                                                switches):
    """use_flash with bf16 compute and head dtype on CPU tensors (the ops'
    plain versions): vit_pair_blocks alone changes no bit; decoder_stack
    moves the predictions within the stack's tolerance against the layer
    chain (median 1e-3, 95th percentile 5e-3), and by more than nothing.
    The strict path ignores both switches."""
    data = _data(synth_root, 1)
    base = _cfg(data)
    fast = _torch_estimator(dataclasses.replace(base, model=dataclasses.replace(
        base.model, use_flash=True, compute_dtype="bfloat16",
        head_dtype="bfloat16")), weights)
    ds = MP100Dataset(data, mode="test")
    support, query, _ = ds.collate_group(ds.support_groups()[:2])
    _, batch = _first_batch(data)
    default, _ = fast.forward_cached(support, query)
    default_b = fast.forward_batch(batch)[0]

    switches.set_vit_pair_blocks(True)
    paired, _ = fast.forward_cached(support, query)
    assert torch.equal(paired, default)
    assert fused_vit_block.launches2 == 0      # plain version on the CPU

    switches.set_decoder_stack(True)
    for got, ref in ((fast.forward_cached(support, query)[0], default),
                     (fast.forward_batch(batch)[0], default_b)):
        d = (got - ref).abs().numpy()
        assert d.max() > 0.0
        assert np.median(d) <= 1e-3 and np.quantile(d, 0.95) <= 5e-3, \
            (np.median(d), np.quantile(d, 0.95))
    assert fused_decoder.stack_launches == 0

    strict = _torch_estimator(base, weights)
    with_switches = strict.forward_batch(batch)[0]
    switches.set_decoder_stack(None)
    switches.set_vit_pair_blocks(None)
    assert torch.equal(with_switches, strict.forward_batch(batch)[0])


def test_fast_forward_pairs_only_at_even_depth(weights):
    """pair_blocks routes pairs through fused_vit_block2 only when the
    depth is even; either way the features equal the per-block form."""
    bb, _ = weights
    imgs = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32))
    for depth in (2, 1):
        cfg = tdinov2.DinoV2Config(depth=depth, embed_dim=64, num_heads=2)
        vit = tdinov2.DinoViT(cfg, SIZE)
        sd = {k: v for k, v in from_jax_params(bb, {})[0].items()
              if not k.startswith("blocks.") or int(k.split(".")[1]) < depth}
        vit.load_state_dict(sd)
        with torch.no_grad():
            one = tdinov2.fast_forward(vit, imgs, pair_blocks=False)
            two = tdinov2.fast_forward(vit, imgs, pair_blocks=True)
        assert torch.equal(one, two)


def test_strict_fp32_switches_tf32_off_and_restores():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with tapi.strict_fp32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = flags
