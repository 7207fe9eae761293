"""The port's training step, trainer and curriculum against the JAX
package on the CPU.

Weights are initialised once in JAX (flax init at a small size) with the
zero-initialised parts (KptBranch output layers, skeleton zero-conv, mask
token) redrawn from a numpy seed so that every branch carries gradient,
and mapped into the port with convert.from_jax_params. Batches are made
from a numpy seed. 56 px, K=12, heatmap 16, width 64, 2 encoder / decoder
/ skeleton layers, a depth-2 width-64 trunk, dropout 0.

JAX's gradients are read without touching the package: plain SGD
(`optax.sgd`) is passed as the optimizer of `make_train_step`, so the
parameter delta of one step is minus the rate times the gradient; the
rate is 1024 so that the subtraction's rounding (an ulp of the
parameter) stays far below the smallest gradients.

Tolerances: loss dict 1e-4 (fp32 both sides, values of order 0.1-1).
Gradients: |torch - jax| <= 1e-6 + 1e-3 * |jax| on the strict path (two
frameworks summing in different orders through the whole head, fp32;
measured excess over the relative part: 2e-7); on the flash path (bf16
matmul operands inside the attention on both sides, JAX's kernels in
interpret mode) the loss dict to 1e-3 and each gradient tensor to
1e-4 + 0.02 * max|jax gradient| (the gradients of the key-projection
biases are zero in exact arithmetic and bf16 noise of about 1e-5 here).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.config import (Config, DataConfig, ModelConfig,
                                 TrainConfig, stage2_config, stage3_config)
from edgecape_tpu.data import synthetic
from edgecape_tpu.data.loader import Prefetcher
from edgecape_tpu.data.mp100 import MP100Dataset
from edgecape_tpu.models import dinov2 as jdinov2
from edgecape_tpu.models.edgecape import init_model
from edgecape_tpu.train import loop as jloop
from edgecape_tpu_torch import config as tconfig
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.models import dinov2 as tdinov2
from edgecape_tpu_torch.models.convert import from_jax_params, state_from_flax
from edgecape_tpu_torch.models.edgecape import EdgeCape
from edgecape_tpu_torch.models.transformer import Decoder
from edgecape_tpu_torch.train import checkpoint as tck
from edgecape_tpu_torch.train import loop as tloop
from edgecape_tpu_torch.train import state as tstate
from edgecape_tpu_torch.train.curriculum import run_curriculum

K, SIZE, HM, B = 12, 56, 16, 3
TRUNK = jdinov2.DinoV2Config(depth=2, embed_dim=64, num_heads=2)
TORCH_TRUNK = tdinov2.DinoV2Config(depth=2, embed_dim=64, num_heads=2)
SMALL = dict(image_size=SIZE, heatmap_size=HM, backbone_dim=64, d_model=64,
             nhead=2, num_feats=32, dim_feedforward=96,
             similarity_proj_dim=64, dynamic_proj_dim=32,
             num_encoder_layers=2, num_decoder_layers=2,
             skeleton_num_layers=2, dropout=0.0, with_heatmap_loss=True)
LOSS_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-3
SGD_RATE = 1024.0


def _cfg(stage, use_flash=False, max_kpt=K, **kw):
    cfg = Config(model=ModelConfig(max_kpt=max_kpt, use_flash=use_flash,
                                   **{**SMALL, **kw}),
                 train=TrainConfig(batch_size=B, warmup_iters=2))
    return {1: lambda c: c, 2: stage2_config, 3: stage3_config}[stage](cfg)


def _weights(cfg, seed=0):
    """(flax backbone tree, flax head tree) as numpy, zero-inits redrawn."""
    bb = jax.tree.map(np.asarray, jdinov2.init_params(
        jax.random.PRNGKey(seed), SIZE, TRUNK))
    _, head = init_model(jax.random.PRNGKey(seed + 1), cfg.model)
    head = jax.tree.map(np.array, jax.device_get(head))
    rng = np.random.default_rng(seed + 2)

    def rn(a, s):
        return (rng.normal(size=np.shape(a)) * s).astype(np.float32)

    for name, blk in bb.items():
        if name.startswith("block"):
            for ls in ("ls1_gamma", "ls2_gamma"):
                blk[ls] = 0.1 + rn(blk[ls], 0.02)
    for name, sub in head["decoder"].items():
        if name.startswith("kpt_branch"):
            for p in ("kernel", "bias"):
                sub["out"][p] = rn(sub["out"][p], 0.02)
    head["mask_token"] = rn(head["mask_token"], 0.1)
    if "zero_conv_w" in head.get("skeleton", {}):
        head["skeleton"]["zero_conv_w"] = rn(np.zeros(1), 0.5)
        head["skeleton"]["zero_conv_b"] = rn(np.zeros(1), 0.1)
    return bb, head


def _batch(seed=0, k=K):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    adj = np.zeros((B, k, k), f32)
    for i in range(k - 1):
        adj[:, i, i + 1] = adj[:, i + 1, i] = 1.0
    vis = np.ones((B, 1, k), f32)
    vis[0, 0, 9:] = 0.0                      # padded keypoints in row 0
    weight_q = (rng.uniform(size=(B, k)) > 0.2).astype(f32)
    return {
        "img_s": rng.normal(size=(B, 1, SIZE, SIZE, 3)).astype(f32),
        "img_q": rng.normal(size=(B, SIZE, SIZE, 3)).astype(f32),
        "joints_s": rng.uniform(4, SIZE - 4, (B, 1, k, 2)).astype(f32),
        "vis_s": vis,
        "target_q": rng.uniform(size=(B, k, HM, HM)).astype(f32),
        "weight_q": weight_q,
        "joints_q": rng.uniform(4, SIZE - 4, (B, k, 2)).astype(f32),
        "binary_adj": adj,
        "rand_mask": (rng.uniform(size=(B, k)) > 0.5).astype(f32)}


def _jax_step(cfg, weights, batch):
    """(metrics, gradient tree as numpy) of one JAX training step."""
    from edgecape_tpu.models.edgecape import EdgeCape as JEdgeCape
    bb, head = (jax.tree.map(jnp.asarray, t) for t in weights)
    tx = optax.sgd(SGD_RATE)
    step = jax.jit(jloop.make_train_step(JEdgeCape(cfg.model), tx, cfg,
                                         TRUNK))
    state = jloop.TrainState(params=head, opt_state=tx.init(head),
                             step=jnp.zeros((), jnp.int32))
    new, metrics = step(state, bb, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                         / np.float32(SGD_RATE),
                         weights[1], jax.device_get(new.params))
    return {k: float(v) for k, v in metrics.items()}, grads


def _torch_modules(cfg, weights):
    bb_sd, head_sd = from_jax_params(*weights)
    backbone = tdinov2.DinoViT(TORCH_TRUNK, SIZE)
    backbone.load_state_dict(bb_sd)
    backbone.eval().requires_grad_(False)
    model = EdgeCape(cfg.model, use_flash=bool(cfg.model.use_flash))
    model.load_state_dict(head_sd)
    return backbone, model.train()


def _torch_grads(cfg, weights, batch):
    backbone, model = _torch_modules(cfg, weights)
    loss_fn = tloop.make_loss_fn(model, backbone, cfg)
    total, metrics = loss_fn({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    total.backward()
    grads = {n: (p.grad.numpy() if p.grad is not None
                 else np.zeros(tuple(p.shape), np.float32))
             for n, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def steps():
    """Per (stage, use_flash): JAX and torch metrics and gradients of one
    step on the same weights and batch, computed once."""
    cache = {}

    def get(stage, use_flash=False):
        key = (stage, use_flash)
        if key not in cache:
            cfg = _cfg(stage, use_flash)
            weights = _weights(cfg)
            batch = _batch(seed=stage)
            jm, jg = _jax_step(cfg, weights, batch)
            tm, tg = _torch_grads(cfg, weights, batch)
            cache[key] = (jm, {n: v.numpy() for n, v in
                               state_from_flax(jg).items()}, tm, tg)
        return cache[key]

    return get


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_step_loss_dict_matches_jax(steps, stage):
    jm, _, tm, _ = steps(stage)
    assert set(tm) == set(jm)
    assert ("adj_reconstruct_loss" in tm) == (stage > 1)
    for key in jm:
        assert tm[key] == pytest.approx(jm[key], abs=LOSS_TOL), key


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_step_gradients_match_jax(steps, stage):
    _, jg, _, tg = steps(stage)
    assert set(tg) == set(jg)
    live = 0
    for name in sorted(jg):
        np.testing.assert_allclose(tg[name], jg[name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
        live += int(np.abs(jg[name]).max() > 1e-8)
    # the comparison is not one of zeros against zeros
    assert live >= 0.8 * len(jg), (live, len(jg))


def test_step_flash_path_tracks_jax_flash_path(steps):
    """use_flash on both sides in stage 3: the port's plain
    flash_mha_train against the JAX kernels in interpret mode."""
    jm, jg, tm, tg = steps(3, True)
    for key in jm:
        assert tm[key] == pytest.approx(jm[key], abs=1e-3), key
    for name in sorted(jg):
        scale = float(np.abs(jg[name]).max())
        assert np.abs(tg[name] - jg[name]).max() <= 1e-4 + 0.02 * scale, name


def test_reconstruction_gradient_reaches_skeleton_not_decoder(monkeypatch):
    """The masked-reconstruction loss alone: its gradient reaches the
    skeleton's zero-conv, its input projection and the mask token, and
    neither the encoder (the masked tokens are detached) nor any decoder
    parameter."""
    cfg = _cfg(2)
    backbone, model = _torch_modules(cfg, _weights(cfg))
    loss_fn = tloop.make_loss_fn(model, backbone, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=5).items()}
    # the loss dict as the step built it, still attached to the graph
    seen = {}
    orig = tloop.keypoint_losses
    monkeypatch.setattr(tloop, "keypoint_losses", lambda *a, **kw:
                        seen.setdefault("losses", orig(*a, **kw)))
    loss_fn(batch)
    seen["losses"]["adj_reconstruct_loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads["skeleton.zero_conv_w"].abs().max() > 0
    assert grads["mask_token"].abs().max() > 0
    assert grads["query_proj.weight"].abs().max() > 0
    assert grads["encoder_layers.0.linear1.weight"] is None
    assert all(g is None or g.abs().max() == 0
               for n, g in grads.items() if n.startswith("decoder."))


def test_decoder_stops_gradient_between_layers():
    """The initial proposals and each layer's input coordinates carry no
    gradient: a loss on the last trajectory point reaches the proposals
    nowhere, and the first layer's coordinate branch not at all."""
    torch.manual_seed(0)
    dec = Decoder(32, 2, 48, 2, num_feats=16).train()
    g = torch.Generator().manual_seed(1)
    b, k, hw = 2, 5, 9
    with torch.no_grad():
        for branch in dec.kpt_branches:
            branch.out.weight.normal_(0, 0.1, generator=g)
    kp = torch.randn(b, k, 32, generator=g)
    img = torch.randn(b, hw, 32, generator=g)
    props = torch.rand(b, k, 2, generator=g).requires_grad_(True)
    adj = torch.rand(b, 2, k, k, generator=g)
    _, points = dec(kp, img, kp_valid=torch.ones(b, k, dtype=torch.bool),
                    img_pos=torch.randn(b, hw, 32, generator=g),
                    initial_proposals=props, adj=adj)
    assert not points[0].requires_grad
    points[-1].sum().backward()
    assert props.grad is None
    assert dec.kpt_branches[1].out.weight.grad.abs().max() > 0
    assert dec.kpt_branches[0].out.weight.grad is None


def test_fused_ops_are_not_taken_in_training_mode(monkeypatch):
    """use_flash in training mode runs the plain encoder / decoder layers
    (the fused ops detach their weights) and flash_mha_train for the
    self-attention; in eval mode the fused ops: one fused_decoder_layer
    per layer, or the whole decoder as fused_decoder_stack with the
    decoder_stack switch on."""
    import edgecape_tpu_torch.models.edgecape as M
    import edgecape_tpu_torch.models.transformer as T
    calls = {"enc": 0, "dec": 0, "stack": 0, "train": 0, "eval": 0}
    monkeypatch.setenv("EDGECAPE_DEC_STACK", "0")

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(M, "fused_encoder_stack",
                        count("enc", M.fused_encoder_stack))
    monkeypatch.setattr(T, "fused_decoder_layer",
                        count("dec", T.fused_decoder_layer))
    monkeypatch.setattr(T, "fused_decoder_stack",
                        count("stack", T.fused_decoder_stack))
    monkeypatch.setattr(T, "flash_mha_train",
                        count("train", T.flash_mha_train))
    monkeypatch.setattr(T, "flash_mha", count("eval", T.flash_mha))
    cfg = _cfg(3, use_flash=True)
    backbone, model = _torch_modules(cfg, _weights(cfg))
    loss_fn = tloop.make_loss_fn(model, backbone, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=6).items()}
    total, _ = loss_fn(batch)
    total.backward()
    # 2 refine + 2 encoder + 2 decoder self-attentions, the decoder's twice
    assert calls == {"enc": 0, "dec": 0, "stack": 0, "train": 8, "eval": 0}
    enc_w = model.encoder_layers[0].linear1.weight
    dec_w = model.decoder.layers[0].ffn2.weight
    assert enc_w.grad.abs().max() > 0 and dec_w.grad.abs().max() > 0
    model.eval()

    def eval_forward():
        with torch.no_grad():
            model(torch.zeros(B, 4, 4, 64), torch.zeros(B, 1, 4, 4, 64),
                  torch.rand(B, 1, K, HM, HM), torch.ones(B, K),
                  torch.from_numpy(_batch()["binary_adj"]))

    eval_forward()
    assert calls["enc"] == 1 and calls["dec"] == 2 and calls["eval"] == 2
    assert calls["train"] == 8 and calls["stack"] == 0
    monkeypatch.setenv("EDGECAPE_DEC_STACK", "1")
    eval_forward()
    assert calls["enc"] == 2 and calls["dec"] == 2 and calls["stack"] == 1
    model.train()
    loss_fn(batch)[0].backward()
    assert calls["dec"] == 2 and calls["stack"] == 1 and calls["train"] == 16


def test_train_step_updates_trainable_and_keeps_frozen():
    """Stage 3 through make_optimizer + make_train_step: the frozen roots
    are bit-unchanged, trainable ones move, the metrics are finite."""
    cfg = _cfg(3)
    backbone, model = _torch_modules(cfg, _weights(cfg))
    opt, sched = tstate.make_optimizer(cfg.train, 10, model,
                                       cfg.model.model_freeze)
    step = tloop.make_train_step(model, backbone, opt, sched, cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=7).items()}
    metrics = step(batch, torch.Generator().manual_seed(0), 0)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    frozen = ("skeleton", "input_proj", "query_proj")
    moved = 0
    for n, p in model.named_parameters():
        if n.split(".")[0] in frozen:
            assert not p.requires_grad and torch.equal(p, before[n]), n
        else:
            moved += int(not torch.equal(p, before[n]))
    assert moved > 0.8 * sum(1 for n in before
                             if n.split(".")[0] not in frozen)


def test_same_batch_loss_decreases_strictly():
    """A few Adam steps on one re-fed batch lower its loss."""
    cfg = _cfg(2)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lr=1e-3, warmup_iters=1))
    backbone, model = _torch_modules(cfg, _weights(cfg))
    opt, sched = tstate.make_optimizer(cfg.train, 10, model, None)
    step = tloop.make_train_step(model, backbone, opt, sched, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=8).items()}
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(batch, gen, i)["loss"]) for i in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_dropout_draws_come_from_the_generator():
    """With dropout on, the same generator seed repeats the loss, another
    seed changes it, and the global torch seed plays no part."""
    cfg = _cfg(3, dropout=0.1)
    backbone, model = _torch_modules(cfg, _weights(cfg))
    loss_fn = tloop.make_loss_fn(model, backbone, cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed=9).items()}

    def run(seed, global_seed):
        torch.manual_seed(global_seed)
        with torch.no_grad():
            return float(loss_fn(batch, torch.Generator().manual_seed(seed)
                                 )[0])

    assert run(1, 0) == run(1, 99)
    assert run(1, 0) != run(2, 0)
    with pytest.raises(ValueError):
        loss_fn(batch, None)


# ------------------------------------------------------- trainer, on disk
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("mp100train_torch")
    ann = synthetic.generate(str(root), num_classes=3, images_per_class=6,
                             image_size=128, seed=1)
    return DataConfig(ann_file=ann, img_prefix=str(root / "images"),
                      num_shots=1, num_queries=2, num_episodes=1,
                      image_size=SIZE, heatmap_size=HM, max_kpt=16,
                      sigma=1.0)


def _loader(ds, batch_size, **kw):
    return Prefetcher(ds, batch_size, use_native=False, **kw)


def _trainer_cfg(synth, work_dir, **train_kw):
    model = ModelConfig(max_kpt=16, use_flash=False,
                        **{**SMALL, "with_heatmap_loss": False,
                           "dropout": 0.1})
    train = TrainConfig(total_epochs=1, batch_size=3, warmup_iters=2,
                        eval_interval=1, ckpt_interval=1, log_interval=1,
                        num_workers=1, **train_kw)
    return Config(model=model, train_data=synth, val_data=synth,
                  test_data=synth, train=train, work_dir=str(work_dir))


def _trainer(cfg, ds, **kw):
    return tloop.Trainer(cfg, ds, _loader, device="cpu",
                         log_fn=lambda *a: None, backbone_cfg=TORCH_TRUNK,
                         **kw)


def test_fit_checkpoint_eval_and_resume(synth, tmp_path):
    cfg = _trainer_cfg(synth, tmp_path / "fit")
    ds = MP100Dataset(synth, mode="train")
    val = MP100Dataset(synth, mode="val")
    tr = _trainer(cfg, ds, val_ds=val)
    tr.fit()
    work = str(tmp_path / "fit")
    assert tck.latest_checkpoint(work).endswith("epoch_1")
    assert os.path.exists(os.path.join(work, "epoch_1.meta.json"))
    assert tck.best_checkpoint(work).endswith("best_PCK_epoch_1")
    with open(os.path.join(work, "train_log.jsonl")) as f:
        entry = json.loads(f.readline())
    assert 0.0 <= entry["val_pck"] <= 1.0 and "train_loss" in entry
    assert tr.step == tr.steps_per_epoch >= 1
    # resume: a second trainer starts at epoch 1 with the same state
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_epochs=2, eval_interval=1000))
    tr2 = _trainer(cfg2, ds, backbone_state=tr.backbone_state)
    assert tr2.start_epoch == 1 and tr2.step == tr.step
    assert tr2.best_pck == tr.best_pck
    for (n, a), (_, b) in zip(tr.model.state_dict().items(),
                              tr2.model.state_dict().items()):
        assert torch.equal(a, b), n
    assert len(tr2.optimizer.state_dict()["state"]) > 0
    tr2.fit()
    assert tck.latest_checkpoint(work).endswith("epoch_2")


def test_best_checkpoint_numeric_epoch_sort(tmp_path):
    for name in ("best_PCK_epoch_9", "best_PCK_epoch_75",
                 "best_PCK_epoch_120", "best_PCK_epoch_120.meta.json"):
        (tmp_path / name).write_text("x")
    assert tck.best_checkpoint(str(tmp_path)).endswith("best_PCK_epoch_120")
    assert tck.latest_checkpoint(str(tmp_path)) is None


def test_warm_start_merges_by_name_and_shape(synth, tmp_path):
    ds = MP100Dataset(synth, mode="train")
    tr1 = _trainer(_trainer_cfg(synth, tmp_path / "s1"), ds)
    tr1._save("epoch_1", 0)
    cfg2 = dataclasses.replace(
        tconfig.stage2_config(_trainer_cfg(synth, tmp_path / "s2")),
        load_from=str(tmp_path / "s1" / "epoch_1"))
    tr2 = _trainer(cfg2, ds, backbone_state=tr1.backbone_state)
    sd1, sd2 = tr1.model.state_dict(), tr2.model.state_dict()
    assert torch.equal(sd2["input_proj.weight"], sd1["input_proj.weight"])
    assert "skeleton.refine.0.norm1.weight" in sd2
    assert "skeleton.refine.0.norm1.weight" not in sd1
    # a shape mismatch keeps the fresh value
    merged = tck.merge_params({"a": torch.zeros(2), "b": torch.zeros(3)},
                              {"a": torch.ones(2), "b": torch.ones(4)})
    assert merged["a"].sum() == 2 and merged["b"].sum() == 0


def test_full_curriculum_end_to_end(synth, tmp_path):
    cfg = _trainer_cfg(synth, tmp_path / "work", )
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, eval_interval=1000))
    work = str(tmp_path / "work")
    arts = run_curriculum(
        cfg, work, MP100Dataset(synth, mode="train"), _loader,
        test_ds=MP100Dataset(synth, mode="test"), ft_epochs=1,
        device="cpu", log_fn=lambda *a: None, backbone_cfg=TORCH_TRUNK)
    for stage in ("base", "base_skeleton", "base_skeleton_bias"):
        assert arts[stage] is not None and os.path.isfile(arts[stage])
    for dumped in ("base_config.json", "skeleton_config.json",
                   "bias_config.json"):
        assert os.path.exists(os.path.join(work, dumped)), dumped
    t2 = tck.load_checkpoint(arts["base_skeleton"])["model"]
    t3 = tck.load_checkpoint(arts["base_skeleton_bias"])["model"]
    assert "skeleton.refine.0.norm1.weight" in t2
    assert any("bias_mlp" in n for n in t3)
    assert np.isfinite(arts["eval"]["latest"]["PCK"])
    with open(os.path.join(work, "testing_log.txt")) as f:
        assert "PCK" in f.read()


def test_stage_configs_match_the_jax_package():
    base = Config(model=ModelConfig(**SMALL))
    for ours, theirs in ((tconfig.stage2_config(base, 0.3, 2.0),
                          stage2_config(base, 0.3, 2.0)),
                         (tconfig.stage3_config(base), stage3_config(base))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_entry_points_default_to_the_cuda_device(synth, tmp_path):
    """PoseEstimator, Trainer and run_curriculum run on the card unless
    told otherwise, and raise here where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _trainer_cfg(synth, tmp_path / "dev")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoseEstimator(cfg, backbone_cfg=TORCH_TRUNK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloop.Trainer(cfg, [], _loader, backbone_cfg=TORCH_TRUNK)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_curriculum(cfg, str(tmp_path / "dev"), [], _loader,
                       backbone_cfg=TORCH_TRUNK)
