"""The port's training ops against the JAX package on the CPU: the plain
version of flash_mha_train against the JAX kernels in interpret mode, its
dropout, the losses and the PCK probe, the learning-rate schedule, Adam
and the gradient clip. Inputs come from numpy seeds.

Tolerances: attention forward atol = rtol = 0.02 and gradients 0.05 (the
JAX package's own bounds for these kernels, bf16 operands on both sides);
losses 1e-5; schedule 1e-12 relative (float64 against float32 jnp: 1e-6);
Adam's update 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.config import TrainConfig
from edgecape_tpu.models import head as jhead
from edgecape_tpu.ops import flash_attention as jfa
from edgecape_tpu.train import state as jstate
from edgecape_tpu_torch.models import head as thead
from edgecape_tpu_torch.ops import flash_attention as tfa
from edgecape_tpu_torch.train import state as tstate


def _qkvg(rng, b, n, h, d):
    return [rng.normal(size=(b, n, h, d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
def test_flash_train_plain_matches_jax_kernels(use_valid, use_bias):
    rng = np.random.default_rng(5)
    b, n, h, d = 2, 24, 2, 32
    q, k, v, g = _qkvg(rng, b, n, h, d)
    valid = None
    if use_valid:
        valid = np.ones((b, n), bool)
        valid[1, 15:] = False
    bias = (0.3 * rng.normal(size=(b, h, n, n))).astype(np.float32) \
        if use_bias else None
    jvalid = None if valid is None else jnp.asarray(valid)

    def jloss(q, k, v, bias):
        return jnp.sum(jfa.flash_mha_train(q, k, v, jvalid, bias,
                                           interpret=True) * g)

    jargs = [jnp.asarray(t) for t in (q, k, v)] + \
        [None if bias is None else jnp.asarray(bias)]
    jout = jfa.flash_mha_train(*jargs[:3], jvalid, jargs[3], interpret=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3) if use_bias
                      else (0, 1, 2))(*jargs)

    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    tbias = None if bias is None else torch.tensor(bias, requires_grad=True)
    tout = tfa.flash_mha_train(
        *leaves, None if valid is None else torch.from_numpy(valid), tbias)
    assert tout.dtype == torch.float32 and tout.shape == (b, n, h, d)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=0.02, rtol=0.02)
    tgrads = torch.autograd.grad(
        tout, leaves + ([tbias] if use_bias else []), torch.from_numpy(g))
    for name, tg, jg in zip(("dq", "dk", "dv", "dbias"), tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=0.05,
                                   rtol=0.05, err_msg=name)


def test_flash_train_plain_dropout_one_mask_forward_and_backward():
    """rate > 0: a one-hot v makes out[q, k] the dropped probability, so
    the forward shows the mask: the keep share, the 1/(1-rate) scaling,
    and that dv = p_dropped^T g, i.e. the backward used the same mask."""
    rate = 0.4
    rng = np.random.default_rng(6)
    b, n, h = 1, 32, 1
    q, k, _, g = _qkvg(rng, b, n, h, n)
    q, k, g = (torch.from_numpy(t) for t in (q, k, g))
    v = torch.eye(n)[None, :, None, :].clone().requires_grad_(True)

    def fwd(seed):
        return tfa.flash_mha_train(
            q, k, v, dropout_rate=rate,
            generator=torch.Generator().manual_seed(seed))

    out = fwd(3)
    assert torch.equal(out, fwd(3)) and not torch.equal(out, fwd(4))
    p_d = out.detach()[0, :, 0, :].numpy()
    p_full = tfa.flash_mha_train(q, k, v)[0, :, 0, :].detach().numpy()
    kept = p_d > 0
    assert 0.5 < kept.mean() < 0.7
    np.testing.assert_allclose(p_d[kept], p_full[kept] / (1 - rate),
                               atol=0.03, rtol=0.05)
    dv, = torch.autograd.grad(out, v, g)
    np.testing.assert_allclose(dv[0, :, 0, :].numpy(),
                               p_d.T @ g[0, :, 0, :].numpy(), atol=0.05,
                               rtol=0.05)
    with pytest.raises(ValueError):
        tfa.flash_mha_train(q, k, v, dropout_rate=rate)


def test_flash_train_plain_fully_masked_row_is_zero():
    rng = np.random.default_rng(7)
    q, k, v, g = (torch.tensor(t, requires_grad=True)
                  for t in _qkvg(rng, 2, 9, 2, 32))
    valid = torch.ones(2, 9, dtype=torch.bool)
    valid[1] = False
    out = tfa.flash_mha_train(q, k, v, valid)
    grads = torch.autograd.grad(out, (q, k, v), g.detach())
    assert bool((out[1] == 0).all())
    assert all(bool(torch.isfinite(t).all()) and bool((t[1] == 0).all())
               for t in grads)


# ------------------------------------------------------------------ losses
def _loss_inputs(seed=0, b=3, k=7):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    weight = (rng.uniform(size=(b, k)) > 0.3).astype(f32)
    weight[1] = 0.0                              # a sample with no joint
    return dict(
        outputs=rng.uniform(size=(2, b, k, 2)).astype(f32),
        target=rng.uniform(size=(b, k, 2)).astype(f32),
        weight=weight,
        props=rng.uniform(size=(b, k, 2)).astype(f32),
        recon=rng.uniform(size=(b, k, 2)).astype(f32),
        sim=rng.normal(size=(b, k, 4, 4)).astype(f32),
        heat=rng.uniform(size=(b, k, 16, 16)).astype(f32))


def test_keypoint_losses_match_jax():
    x = _loss_inputs()
    kw = dict(skeleton_loss_weight=0.7, with_heatmap_loss=True,
              heatmap_loss_weight=2.0)
    jl = jhead.keypoint_losses(
        jnp.asarray(x["outputs"]), jnp.asarray(x["target"]),
        jnp.asarray(x["weight"]), proposals_for_loss=jnp.asarray(x["props"]),
        recon=jnp.asarray(x["recon"]), similarity=jnp.asarray(x["sim"]),
        target_heatmap=jnp.asarray(x["heat"]), **kw)
    t = {n: torch.from_numpy(v) for n, v in x.items()}
    tl = thead.keypoint_losses(
        t["outputs"], t["target"], t["weight"], proposals_for_loss=t["props"],
        recon=t["recon"], similarity=t["sim"], target_heatmap=t["heat"], **kw)
    assert list(tl) == list(jl)
    for name in jl:
        assert float(tl[name]) == pytest.approx(float(jl[name]), abs=1e-5), \
            name
    # without the optional terms
    tl = thead.keypoint_losses(t["outputs"], t["target"], t["weight"])
    assert list(tl) == ["l1_loss_layer0", "l1_loss_layer1"]


@pytest.mark.parametrize("fn", ["masked_l1", "reconstruction_loss",
                                "heatmap_mse_loss"])
def test_each_loss_matches_jax(fn):
    x = _loss_inputs(seed=1)
    args = {"masked_l1": ("props", "target", "weight"),
            "reconstruction_loss": ("recon", "target", "weight"),
            "heatmap_mse_loss": ("sim", "heat", "weight")}[fn]
    extra = () if fn == "masked_l1" else (1.5,)
    jv = getattr(jhead, fn)(*(jnp.asarray(x[a]) for a in args), *extra)
    tv = getattr(thead, fn)(*(torch.from_numpy(x[a]) for a in args), *extra)
    assert float(tv) == pytest.approx(float(jv), abs=1e-5)


@pytest.mark.parametrize("src,dst", [(16, 4), (64, 16), (4, 8), (5, 5)])
def test_torch_bilinear_matrix_matches_jax(src, dst):
    np.testing.assert_array_equal(
        thead.torch_bilinear_matrix(src, dst),
        np.asarray(jhead._torch_bilinear_matrix(src, dst)))


@pytest.mark.parametrize("all_invisible", [False, True])
def test_pck_accuracy_matches_jax(all_invisible):
    x = _loss_inputs(seed=2)
    weight = np.zeros_like(x["weight"]) if all_invisible else x["weight"]
    pred, target = x["props"] * 56.0, x["target"] * 56.0
    pred[0, :3] = target[0, :3] + 1.0            # some hits
    sizes = np.full((3, 2), 56.0, np.float32)
    jv = jhead.pck_accuracy(jnp.asarray(pred), jnp.asarray(target),
                            jnp.asarray(weight), jnp.asarray(sizes))
    tv = thead.pck_accuracy(torch.from_numpy(pred), torch.from_numpy(target),
                            torch.from_numpy(weight),
                            torch.from_numpy(sizes))
    assert float(tv) == pytest.approx(float(jv), abs=1e-5)
    assert (float(tv) == 0.0) == all_invisible


# ---------------------------------------------------------- optimizer side
def test_lr_schedule_matches_jax():
    cfg = TrainConfig(lr=1e-5, warmup_iters=10, warmup_ratio=0.001,
                      lr_step=(3, 5), lr_gamma=0.1)
    spe = 7
    jsched = jstate.lr_schedule(cfg, spe)
    tsched = tstate.lr_schedule(cfg, spe)
    steps = [0, 1, 5, 9, 10, 11, 20, 21, 22, 34, 35, 36, 37, 100]
    for step in steps:
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-6), \
            step
    # warm-up ends at warmup_iters; the decay applies from each boundary
    assert tsched(10) == pytest.approx(1e-5, rel=1e-12)
    assert tsched(20) == pytest.approx(1e-5, rel=1e-12)
    assert tsched(21) == pytest.approx(1e-6, rel=1e-12)
    assert tsched(35) == pytest.approx(1e-7, rel=1e-12)


@pytest.mark.parametrize("grad_clip", [None, 0.05])
def test_adam_steps_match_optax(grad_clip):
    """Three updates of a small two-root module on given gradients
    against optax's chain of the JAX package (clip, Adam at the scheduled
    rate, the freeze mask): parameters agree to 1e-6 relative, the frozen
    root does not move."""
    cfg = TrainConfig(lr=1e-3, warmup_iters=2, warmup_ratio=0.1,
                      lr_step=(1,), lr_gamma=0.5, grad_clip=grad_clip)
    rng = np.random.default_rng(3)
    shapes = {"decoder": (4, 3), "skeleton": (5,), "proposal_gen": (2, 2)}
    params = {n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32) * 0.1
              for n, s in shapes.items()} for _ in range(3)]

    jparams = {n: {"w": jnp.asarray(v)} for n, v in params.items()}
    tx, _ = jstate.make_optimizer(cfg, 2, jparams, "skeleton")
    state = tx.init(jparams)
    for g in grads:
        upd, state = tx.update({n: {"w": jnp.asarray(v)}
                                for n, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)

    class Root(torch.nn.Module):
        def __init__(self, v):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(v.copy()))

    model = torch.nn.ModuleDict({n: Root(v) for n, v in params.items()})
    opt, sched = tstate.make_optimizer(cfg, 2, model, "skeleton")
    assert not model["skeleton"].w.requires_grad
    trainable = [p for p in model.parameters() if p.requires_grad]
    for step, g in enumerate(grads):
        opt.zero_grad()
        for n in shapes:
            if model[n].w.requires_grad:
                model[n].w.grad = torch.from_numpy(g[n].copy())
        if grad_clip is not None:
            tstate.clip_by_global_norm(trainable, grad_clip)
        tstate.apply_lr(opt, sched(step))
        opt.step()
    for n in shapes:
        np.testing.assert_allclose(model[n].w.detach().numpy(),
                                   np.asarray(jparams[n]["w"]), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    np.testing.assert_array_equal(model["skeleton"].w.detach().numpy(),
                                  params["skeleton"])


def test_freeze_sets_cover_the_jax_roots():
    """The port's frozen roots are the JAX package's, under the port's
    module names (enc0..enc5 are the entries of encoder_layers)."""
    assert set(tstate.FREEZE_SETS) == set(jstate.FREEZE_SETS)
    for mode, roots in jstate.FREEZE_SETS.items():
        mapped = {"encoder_layers" if r.startswith("enc") else r
                  for r in roots}
        assert mapped == set(tstate.FREEZE_SETS[mode]), mode
