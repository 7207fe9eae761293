"""Training step and epoch loop; counterpart of edgecape_tpu/train/loop.py.

One step: the frozen backbone under no_grad (on a CUDA device through
the hand-written fused_vit_block op, on the CPU the plain trunk), the
support heatmaps rendered on the device from the joints, encode ->
decode, and for masked supervision the reconstruction branch: the
decoder applied once more to the masked tokens with its parameters
detached (`torch.func.functional_call`), so that this loss moves the
skeleton branch and the mask token and not the decoder. Then the loss
dict, Adam at the scheduled rate, and the train-time PCK probe.

The trainer takes its data as objects: a dataset with `__len__`,
`num_shots` and `resample_episodes()`, and a loader factory called as
`loader_factory(dataset, batch_size, shuffle=True, masking_ratio=...,
drop_last=True, num_workers=..., seed=...)` whose result's `epoch()`
yields batches carrying the `BATCH_KEYS` arrays (as attributes or as a
dict). It imports no loader itself.

Multi-process (a process group joined by parallel/multihost.initialize
before the trainer is built, one process per device; the trainer reads
multihost.process_count / process_index, as the eval runner does):
every process starts from process 0's weights,
collates only its row block of each global batch (the loader factory is
given `shard=(rank, world)`), and after the backward pass the gradients
of all processes are averaged in one all-reduce of a flat buffer, before
the clip and Adam, so that every process applies the global batch's
update (JAX's psum; a parameter without a gradient counts as zero and
keeps no gradient where no process has one). Every loss term is a batch
mean of per-sample terms, so the mean over equal shards is the global
batch's loss; the logged losses are averaged the same way, and the PCK
probe is formed from the summed numerator and denominator. The dropout
generator of process r is seeded with `train.seed + r`, so the shards
draw different masks. Only process 0 writes checkpoints, the log and
TensorBoard, and every process waits for a checkpoint to be complete
before it goes on. The eval hook runs on every process over its share of
the episodes (eval/runner.py gathers the records).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import torch

from .. import __version__
from .. import config as config_lib
from ..api import resolve_device
from ..models import dinov2
from ..models.convert import init_params
from ..models.edgecape import EdgeCape
from ..models.head import keypoint_losses, pck_counts, pck_from_counts
from ..ops import heatmap
from ..ops.kernel_config import require_widths
from ..parallel import multihost
from ..staging import HostStager
from . import checkpoint as ckpt_lib
from .state import apply_lr, clip_by_global_norm, make_optimizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

BATCH_KEYS = ("img_s", "img_q", "joints_s", "vis_s", "target_q",
              "weight_q", "joints_q", "binary_adj", "rand_mask")


def batch_to_tensors(batch, device, stager=None) -> dict:
    """The BATCH_KEYS arrays of a loader batch (attributes or dict
    entries) as tensors on `device`, through `stager` (a HostStager for
    that device, which a caller of many steps keeps) when one is given."""
    get = batch.__getitem__ if isinstance(batch, dict) else \
        (lambda k: getattr(batch, k))
    stage = stager or HostStager(device)
    return {k: stage(get(k), k) for k in BATCH_KEYS}


def make_loss_fn(model: EdgeCape, backbone: dinov2.DinoViT, cfg,
                 with_pck_counts: bool = False):
    """loss_fn(batch, generator) -> (total loss, metrics dict of 0-d
    tensors), and the PCK probe's two sums (models/head.py pck_counts) as
    a third item with `with_pck_counts`. `batch`: the BATCH_KEYS tensors
    on the model's device, images ImageNet-normalised floats; `generator`
    feeds every dropout draw of the step."""
    mcfg = cfg.model
    size = float(mcfg.image_size)
    bb_dtype = _DTYPES[mcfg.compute_dtype]
    hs = mcfg.heatmap_size
    sigma = cfg.train_data.sigma
    if cfg.train_data.use_udp:
        render = heatmap.render_udp
    elif getattr(cfg.train_data, "unbiased_encoding", False):
        render = heatmap.render_msra_unbiased
    else:
        render = heatmap.render_msra

    def extract(imgs):
        # The backbone is frozen, so on a CUDA device its bf16 fused-block
        # path is valid under training whatever the compute dtype: the
        # features are rounded to bf16 and the head still trains at the
        # compute dtype. train_backbone_fast=False keeps the plain trunk.
        with torch.no_grad():
            if mcfg.train_backbone_fast and imgs.is_cuda:
                return dinov2.fast_forward(backbone, imgs)
            return backbone(imgs.to(bb_dtype)).float()

    def loss_fn(batch, generator=None):
        b, s = batch["img_s"].shape[:2]
        imgs = torch.cat(
            [batch["img_s"].reshape((b * s,) + batch["img_s"].shape[2:]),
             batch["img_q"]], dim=0)
        feats = extract(imgs)
        gh, gw = feats.shape[1:3]
        feat_s = feats[:b * s].reshape(b, s, gh, gw, -1)
        feat_q = feats[b * s:]
        target_s, weight_s = render(batch["joints_s"], batch["vis_s"],
                                    (hs, hs), (size, size), sigma)
        mask_s = torch.prod(weight_s[..., 0], dim=1)              # [B, K]

        enc = model.encode(feat_q, feat_s, target_s, mask_s,
                           batch["binary_adj"], generator=generator)
        outputs, _ = model.decode(enc.kp_tokens, enc.img_tokens,
                                  enc.proposals, enc.adj, enc.hop_stack,
                                  enc.kp_valid, enc.img_pos,
                                  generator=generator)
        recon = None
        if mcfg.masked_supervision:
            masked_tokens = model.mask_tokens(enc.kp_tokens,
                                              batch["rand_mask"],
                                              enc.kp_valid)
            frozen = {n: p.detach()
                      for n, p in model.decoder.named_parameters()}
            _, recon_points = torch.func.functional_call(
                model.decoder, frozen,
                (masked_tokens, enc.img_tokens.detach()),
                dict(kp_valid=enc.kp_valid, img_pos=enc.img_pos.detach(),
                     initial_proposals=enc.proposals.detach(), adj=enc.adj,
                     hop_stack=enc.hop_stack, generator=generator))
            recon = recon_points[-1]

        weight = batch["weight_q"] * mask_s                       # [B, K]
        targets_norm = batch["joints_q"] / size
        losses = keypoint_losses(
            outputs, targets_norm, weight,
            proposals_for_loss=enc.proposals_for_loss, recon=recon,
            skeleton_loss_weight=mcfg.skeleton_loss_weight,
            similarity=enc.similarity, target_heatmap=batch["target_q"],
            with_heatmap_loss=mcfg.with_heatmap_loss,
            heatmap_loss_weight=mcfg.heatmap_loss_weight)
        total = sum(losses.values())
        with torch.no_grad():
            counts = pck_counts(outputs[-1] * size, batch["joints_q"],
                                weight, torch.full((b, 2), size,
                                                   device=weight.device))
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["acc_pose"] = pck_from_counts(counts)
        if with_pck_counts:
            return total, metrics, counts
        return total, metrics

    return loss_fn


def reduce_across_processes(params, metrics: dict,
                            counts: torch.Tensor) -> dict:
    """Averages the gradients of `params` and the loss metrics over the
    processes in one all-reduce, in place for the gradients; returns the
    metrics of the global batch (the PCK probe from the summed counts).
    A gradient that is None on a process counts as zero there; a
    parameter that no process gave a gradient keeps None."""
    world = multihost.process_count()
    names = [k for k in metrics if k != "acc_pose"]
    dev = counts.device
    has = torch.tensor([float(p.grad is not None) for p in params],
                       device=dev)
    flat = torch.cat(
        [has, torch.stack([metrics[k].float() for k in names]),
         counts.float()]
        + [(p.grad if p.grad is not None else torch.zeros_like(p))
           .reshape(-1).float() for p in params])
    flat = multihost.allreduce_sum(flat)
    n, m = len(params), len(names)
    out = {k: flat[n + i] / world for i, k in enumerate(names)}
    out["acc_pose"] = pck_from_counts(flat[n + m:n + m + 2])
    off = n + m + 2
    for p, any_grad in zip(params, flat[:n].tolist()):
        size = p.numel()
        if any_grad > 0:
            p.grad = (flat[off:off + size] / world).view_as(p).to(p.dtype)
        off += size
    return {k: out[k] for k in metrics}


def make_train_step(model: EdgeCape, backbone: dinov2.DinoViT, optimizer,
                    sched: Callable[[int], float], cfg):
    """train_step(batch, generator, step) -> metrics: one update of the
    trainable parameters in place, at the rate of `sched(step)` (the step
    count before the update). The gradients stay in `.grad` until the
    next step. With more than one process, `batch` is this
    process's row block and the gradients and metrics are those of the
    global batch (reduce_across_processes)."""
    multiprocess = multihost.process_count() > 1
    loss_fn = make_loss_fn(model, backbone, cfg, with_pck_counts=True)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    grad_clip = cfg.train.grad_clip

    def train_step(batch, generator, step: int):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total, metrics, counts = loss_fn(batch, generator)
        total.backward()
        if multiprocess:
            metrics = reduce_across_processes(params, metrics, counts)
        if grad_clip is not None:
            clip_by_global_norm(params, grad_clip)
        apply_lr(optimizer, sched(step))
        optimizer.step()
        return metrics

    return train_step


def build_train_modules(cfg, device: torch.device, backbone_state: dict,
                        head_state: dict, steps_per_epoch: int,
                        backbone_cfg: dinov2.DinoV2Config = dinov2.VIT_S14,
                        log_fn: Optional[Callable] = None):
    """(backbone, model, optimizer, sched) of a training run on `device`:
    the frozen trunk (on a CUDA device with model.train_backbone_fast the
    fused bf16 blocks over fp32 parameters, whose widths it checks; else
    the plain trunk at the compute dtype), the head with
    `cfg.model.use_flash` (resolved by the caller), Adam and its schedule
    (train/state.make_optimizer)."""
    mcfg = cfg.model
    if mcfg.train_backbone_fast:
        require_widths(("fused_vit_block",),
                       dinov2.width_misfits(mcfg, backbone_cfg), device,
                       "model.train_backbone_fast=False")
    fast = mcfg.train_backbone_fast and device.type == "cuda"
    backbone = dinov2.DinoViT(backbone_cfg, mcfg.image_size)
    backbone.load_state_dict(backbone_state)
    backbone.to(device, torch.float32 if fast else
                _DTYPES[mcfg.compute_dtype]).eval()
    backbone.requires_grad_(False)
    if fast and log_fn is not None:
        log_fn("train step: fused bf16 backbone active "
               "(model.train_backbone_fast=false for the plain trunk)")
    model = EdgeCape(mcfg, use_flash=mcfg.use_flash, device=device)
    model.load_state_dict(head_state)
    model.to(device)
    optimizer, sched = make_optimizer(cfg.train, steps_per_epoch, model,
                                      mcfg.model_freeze)
    return backbone, model, optimizer, sched


class Trainer:
    """Epoch-based trainer with an eval hook, best-PCK tracking,
    checkpoints and resume. Runs on the CUDA device unless `device` says
    otherwise. In a process group (multihost.initialize, before the
    trainer is built): data-parallel over its processes, each on its own
    `device` (see the module docstring)."""

    def __init__(self, cfg, train_ds, loader_factory, val_ds=None,
                 backbone_state: Optional[dict] = None, device="cuda",
                 log_fn=print,
                 backbone_cfg: dinov2.DinoV2Config = dinov2.VIT_S14):
        self.device = resolve_device(device)
        self.world = multihost.process_count()
        self.rank = multihost.process_index()
        self.primary = self.rank == 0
        self._stage = HostStager(self.device)
        flash = cfg.model.use_flash
        use_flash = bool(self.device.type == "cuda" if flash is None
                         else flash)
        cfg = config_lib.replace(cfg, model=config_lib.replace(
            cfg.model, use_flash=use_flash))
        self.cfg = cfg
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.loader_factory = loader_factory
        self.log = log_fn
        self.backbone_cfg = backbone_cfg

        init_gen = torch.Generator().manual_seed(cfg.train.seed)
        bb_state, head_state = init_params(init_gen, cfg.model, backbone_cfg)
        self.backbone_state = bb_state if backbone_state is None \
            else backbone_state
        # warm start (the curriculum's load_from between stages)
        if cfg.load_from:
            loaded = ckpt_lib.load_checkpoint(cfg.load_from)
            head_state = ckpt_lib.merge_params(head_state,
                                               loaded.get("model", loaded))
            self.log(f"warm-started from {cfg.load_from}")
        if self.world > 1:
            # every process starts from process 0's weights
            head_state = multihost.replicate_global(head_state)
            self.backbone_state = multihost.replicate_global(
                self.backbone_state)

        self.steps_per_epoch = max(len(train_ds) // cfg.train.batch_size, 1)
        self.backbone, self.model, self.optimizer, self.sched = \
            build_train_modules(cfg, self.device, self.backbone_state,
                                head_state, self.steps_per_epoch,
                                backbone_cfg, self.log)
        self.step = 0
        self.start_epoch = 0
        self.best_pck = -1.0
        # offset by the rank: each shard draws its own dropout masks
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + self.rank)
        self._eval_estimator = None

        # auto-resume from the work directory's latest checkpoint
        resume = cfg.resume_from or ckpt_lib.latest_checkpoint(cfg.work_dir)
        if resume:
            tree = ckpt_lib.load_checkpoint(resume)
            self.model.load_state_dict(tree["model"])
            self.optimizer.load_state_dict(tree["optimizer"])
            self.step = int(tree["step"])
            self.start_epoch = int(tree["epoch"]) + 1
            self.best_pck = float(tree["best_pck"])
            self.log(f"resumed from {resume} at epoch {self.start_epoch}")

        self._step_fn = make_train_step(self.model, self.backbone,
                                        self.optimizer, self.sched, cfg)

    def train_step(self, batch) -> dict:
        """One update on a loader batch (or a dict of BATCH_KEYS arrays);
        returns the metrics as 0-d tensors on the device."""
        metrics = self._step_fn(batch_to_tensors(batch, self.device,
                                                 self._stage),
                                self.generator, self.step)
        self.step += 1
        return metrics

    # -------------------------------------------------------------- save
    def _save(self, name: str, epoch: int) -> None:
        """Process 0 writes; every process returns once the file, its
        sidecar and latest.json are complete."""
        if self.primary:
            self._write(name, epoch)
        multihost.barrier()

    def _write(self, name: str, epoch: int) -> None:
        os.makedirs(self.cfg.work_dir, exist_ok=True)
        ckpt_lib.save_checkpoint(
            os.path.join(self.cfg.work_dir, name),
            {"model": self.model.state_dict(),
             "optimizer": self.optimizer.state_dict(),
             "step": self.step, "epoch": epoch, "best_pck": self.best_pck})
        with open(os.path.join(self.cfg.work_dir, name + ".meta.json"),
                  "w") as f:
            json.dump({"version": __version__, "epoch": epoch,
                       "config": config_lib.asdict(self.cfg)}, f,
                      default=str)
        ckpt_lib.write_latest(self.cfg.work_dir, name)

    # -------------------------------------------------------------- eval
    def _evaluate(self) -> float:
        from ..api import PoseEstimator
        from ..eval.runner import run_eval
        # one estimator for the run; the live head weights are swapped in
        # at each eval
        if self._eval_estimator is None:
            self._eval_estimator = PoseEstimator(
                self.cfg, self.backbone_state, self.model.state_dict(),
                device=self.device, backbone_cfg=self.backbone_cfg)
        else:
            self._eval_estimator.load_head_state(self.model.state_dict())
        res = run_eval(self.val_ds, self._eval_estimator,
                       batch_size=max(self.cfg.train.batch_size, 1),
                       res_folder=self.cfg.work_dir, progress=False,
                       cache_supports=True)
        return float(res["PCK"])

    # --------------------------------------------------------------- fit
    def fit(self) -> None:
        cfg = self.cfg
        masking = (cfg.model.masking_ratio
                   if cfg.model.masked_supervision else 0.0)
        os.makedirs(cfg.work_dir, exist_ok=True)
        log_path = os.path.join(cfg.work_dir, "train_log.jsonl")
        # each process collates its row block of identically planned
        # batches (the plans draw from the loader's own seeded rng)
        shard = {"shard": (self.rank, self.world)} if self.world > 1 \
            else {}
        loader = self.loader_factory(
            self.train_ds, cfg.train.batch_size, shuffle=True,
            masking_ratio=masking, drop_last=True,
            num_workers=cfg.train.num_workers, seed=cfg.train.seed, **shard)

        tb = None
        if getattr(cfg.train, "tensorboard", False) and self.primary:
            from ..utils.tb_writer import SummaryWriter
            tb = SummaryWriter(os.path.join(cfg.work_dir, "tf_logs"))

        for epoch in range(self.start_epoch, cfg.train.total_epochs):
            t0 = time.time()
            agg, n_agg, n_it = {}, 0, 0
            for batch in loader.epoch():
                metrics = self.train_step(batch)
                n_it += 1
                if n_it % cfg.train.log_interval == 0 or n_it == 1:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    for k, v in metrics.items():
                        agg[k] = agg.get(k, 0.0) + v
                    n_agg += 1
                    self.log(f"epoch {epoch} it {n_it}/"
                             f"{self.steps_per_epoch} "
                             + " ".join(f"{k}={v:.4f}"
                                        for k, v in sorted(metrics.items())))
                    if tb is not None:
                        for k, v in metrics.items():
                            tb.add_scalar(f"train/{k}", v, self.step)
                        tb.add_scalar("train/lr",
                                      float(self.sched(self.step)), self.step)
            # after the epoch: reshuffle the episode pairs
            self.train_ds.resample_episodes()

            entry = {"epoch": epoch, "time": round(time.time() - t0, 2),
                     "lr": float(self.sched(self.step))}
            if n_agg:  # epoch mean of the sampled train metrics
                entry.update({f"train_{k}": round(v / n_agg, 6)
                              for k, v in sorted(agg.items())})
            if self.val_ds is not None and \
                    (epoch + 1) % cfg.train.eval_interval == 0:
                pck = self._evaluate()
                entry["val_pck"] = pck
                if tb is not None:
                    tb.add_scalar("val/PCK", pck, self.step)
                if pck > self.best_pck:
                    self.best_pck = pck
                    self._save(f"best_PCK_epoch_{epoch + 1}", epoch)
                self.log(f"epoch {epoch} val PCK={pck:.4f} "
                         f"(best {self.best_pck:.4f})")
            if (epoch + 1) % cfg.train.ckpt_interval == 0 or \
                    epoch + 1 == cfg.train.total_epochs:
                self._save(f"epoch_{epoch + 1}", epoch)
            if self.primary:
                with open(log_path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
            if tb is not None:
                tb.flush()
        if tb is not None:
            tb.close()
