"""Configuration helpers of the port.

The port reads its configuration by attribute from any object with the
fields of edgecape_tpu.config's Config / ModelConfig / DataConfig /
TrainConfig: a dataclass (the JAX package's own classes work as they
are) or a `types.SimpleNamespace`. `replace` and `asdict` work on both;
`stage2_config` / `stage3_config` spell the curriculum stages
(counterparts of edgecape_tpu/config.py's functions of the same names).
"""

from __future__ import annotations

import copy
import dataclasses
import json


def replace(obj, **changes):
    """A copy of `obj` with the given fields changed."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **changes)
    out = copy.copy(obj)
    for k, v in changes.items():
        if not hasattr(out, k):
            raise KeyError(f"unknown config field {k!r}")
        setattr(out, k, v)
    return out


def asdict(obj):
    """Nested plain dicts of a configuration object."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if hasattr(obj, "__dict__"):
        return {k: asdict(v) for k, v in vars(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [asdict(v) for v in obj]
    return obj


def dump(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(asdict(cfg), f, indent=2, default=str)


def stage2_config(cfg, masking_ratio: float = 0.5,
                  skeleton_loss_weight: float = 1.0):
    """Curriculum stage 2: learned edge weights and masked-keypoint
    supervision."""
    model = replace(cfg.model, learn_skeleton=True, masked_supervision=True,
                    masking_ratio=masking_ratio,
                    skeleton_loss_weight=skeleton_loss_weight)
    return replace(cfg, model=model)


def stage3_config(cfg):
    """Curriculum stage 3: stage 2 plus the structural attention bias,
    with the skeleton branch frozen."""
    model = replace(stage2_config(cfg).model, use_bias_attn_module=True,
                    attn_bias=True, max_hops=4, model_freeze="skeleton")
    return replace(cfg, model=model)
