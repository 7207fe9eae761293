"""Weights for the port's modules.

`from_jax_params` maps the JAX package's flax parameter trees (given as
nested dicts of numpy arrays, e.g. `jax.tree.map(np.asarray, params)`)
onto state dicts that `DinoViT` and `EdgeCape` load strictly: flax Dense
kernels are [in, out] and become torch Linear weights [out, in];
LayerNorm `scale` becomes `weight`; numbered flax submodules (`block3`,
`enc0`, `layer2`, `kpt_branch1`, `refine0`) become ModuleList entries.

`init_params` draws the same shapes from a seeded torch.Generator on a
machine without jax (xavier-uniform Linear weights and zero biases like
the flax initialisers, normal(0.02) position embedding, LayerScale at
1e-5, zero-initialised KptBranch output and skeleton zero-conv).
`redraw_zero_inits` replaces those zero / 1e-5 initialisations with
seeded random values, so that a check of the forward exercises every
part of it.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from .dinov2 import DinoV2Config, DinoViT, VIT_S14
from .edgecape import EdgeCape

_RENAMES = [
    (re.compile(r"^block(\d+)$"), r"blocks.\1"),
    (re.compile(r"^enc(\d+)$"), r"encoder_layers.\1"),
    (re.compile(r"^layer(\d+)$"), r"layers.\1"),
    (re.compile(r"^kpt_branch(\d+)$"), r"kpt_branches.\1"),
    (re.compile(r"^refine(\d+)$"), r"refine.\1"),
    (re.compile(r"^ls([12])_gamma$"), r"ls\1"),
]


def _name(key: str) -> str:
    for pat, rep in _RENAMES:
        if pat.match(key):
            return pat.sub(rep, key)
    return key


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    keys = set(tree)
    if keys == {"kernel", "bias"}:
        out[prefix + "weight"] = np.asarray(tree["kernel"]).T
        out[prefix + "bias"] = np.asarray(tree["bias"])
        return
    if keys == {"scale", "bias"}:
        out[prefix + "weight"] = np.asarray(tree["scale"])
        out[prefix + "bias"] = np.asarray(tree["bias"])
        return
    for k, v in tree.items():
        name = prefix + _name(k)
        if isinstance(v, dict):
            _flatten(v, name + ".", out)
        else:
            out[name] = np.asarray(v)


def state_from_flax(tree: dict) -> dict:
    """A flax parameter (sub)tree of numpy arrays -> torch state dict."""
    flat = {}
    _flatten(dict(tree), "", flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def from_jax_params(backbone_np: dict, head_np: dict):
    """(backbone state dict for DinoViT, head state dict for EdgeCape)."""
    return state_from_flax(backbone_np), state_from_flax(head_np)


def init_params(generator: torch.Generator, cfg,
                backbone_cfg: DinoV2Config = VIT_S14):
    """Seeded (backbone, head) state dicts for `cfg` (a ModelConfig)."""
    out = []
    for module in (DinoViT(backbone_cfg, image_size=cfg.image_size),
                   EdgeCape(cfg)):
        with torch.no_grad():
            for name, sub in module.named_modules():
                if isinstance(sub, torch.nn.Linear):
                    fan_out, fan_in = sub.weight.shape
                    bound = math.sqrt(6.0 / (fan_in + fan_out))
                    sub.weight.copy_((torch.rand(sub.weight.shape,
                                                 generator=generator) * 2
                                      - 1) * bound)
                    sub.bias.zero_()
                    if re.search(r"kpt_branches\.\d+\.out$", name):
                        sub.weight.zero_()
                elif isinstance(sub, torch.nn.LayerNorm):
                    sub.weight.fill_(1.0)
                    sub.bias.zero_()
            for name, p in module.named_parameters():
                if name.endswith("pos_embed"):
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
                elif re.search(r"\.ls[12]$", name):
                    p.fill_(backbone_cfg.layerscale_init)
                elif name.endswith(("cls_token", "mask_token",
                                    "zero_conv_w", "zero_conv_b")):
                    p.zero_()
        out.append({k: v.detach().clone() for k, v in
                    module.state_dict().items()})
    return out[0], out[1]


def redraw_zero_inits(backbone_sd: dict, head_sd: dict,
                      generator: torch.Generator) -> None:
    """In place: LayerScale ~ 0.1 + 0.02 N(0,1), KptBranch output layer
    ~ 0.02 N(0,1), skeleton zero-conv weight ~ 0.5 N(0,1) and bias
    ~ 0.1 N(0,1)."""
    def rn(t, s):
        return torch.randn(t.shape, generator=generator) * s

    for name, v in backbone_sd.items():
        if re.search(r"\.ls[12]$", name):
            backbone_sd[name] = 0.1 + rn(v, 0.02)
    for name, v in head_sd.items():
        if re.search(r"kpt_branches\.\d+\.out\.", name):
            head_sd[name] = rn(v, 0.02)
        elif name.endswith("zero_conv_w"):
            head_sd[name] = rn(v, 0.5)
        elif name.endswith("zero_conv_b"):
            head_sd[name] = rn(v, 0.1)
