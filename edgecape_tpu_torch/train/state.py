"""Optimizer, learning-rate schedule and curriculum freezing; counterpart
of edgecape_tpu/train/state.py.

Adam with lr 1e-5, a linear warm-up over `warmup_iters` steps from
`warmup_ratio`, a step decay by `lr_gamma` at the `lr_step` epochs, an
optional clip of the global gradient norm, and the freeze sets of the
curriculum. Freezing is `requires_grad_(False)` on the frozen roots:
activations still flow, the parameters take no gradient and no update.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# roots of the head module (models/edgecape.py) that a freeze mode holds
# fixed
FREEZE_SETS = {
    # stage 3 freezes the skeleton branch and the input projections
    "skeleton": ("skeleton", "input_proj", "query_proj"),
    # or the prediction stack instead
    "prediction": ("decoder", "encoder_layers", "proposal_gen",
                   "mask_token"),
}


def lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate: linear warm-up (warmup_ratio -> 1) over
    warmup_iters steps, times the base rate decayed by lr_gamma from each
    boundary `epoch * steps_per_epoch` on."""
    boundaries = [int(e * steps_per_epoch) for e in cfg.lr_step]

    def schedule(step: int) -> float:
        base = cfg.lr
        for b in boundaries:
            if step >= b:
                base = base * cfg.lr_gamma
        warm = min(step / max(cfg.warmup_iters, 1), 1.0)
        return base * (cfg.warmup_ratio + (1.0 - cfg.warmup_ratio) * warm)

    return schedule


def frozen_roots(model_freeze: Optional[str]) -> tuple:
    return FREEZE_SETS[model_freeze] if model_freeze else ()


def make_optimizer(cfg, steps_per_epoch: int, model: torch.nn.Module,
                   model_freeze: Optional[str] = None):
    """Freezes `model`'s frozen roots in place and returns (Adam over the
    rest, schedule). The caller sets the group's lr to
    schedule(step before the update) at every step (`apply_lr`)."""
    sched = lr_schedule(cfg, steps_per_epoch)
    roots = frozen_roots(model_freeze)
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] not in roots)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=sched(0), betas=(0.9, 0.999),
                           eps=1e-8)
    return opt, sched


def apply_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def clip_by_global_norm(params, max_norm: float) -> None:
    """Scales the gradients in place by max_norm / norm when their global
    norm exceeds max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
