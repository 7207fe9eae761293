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

`load_backbone` reads backbone weights from disk: a torch-hub DINOv2
state dict (`.pth`), converted like the JAX package's
`dinov2.convert_torch_state_dict`, or a checkpoint file of the port.
"""

from __future__ import annotations

import math
import re
from typing import Optional

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


def resize_pos_embed(pos_embed: torch.Tensor, src_grid: int, dst_hw,
                     offset: float = 0.1) -> torch.Tensor:
    """Bicubic-resize the patch position grid [1, 1 + g*g, C], keeping
    the cls slot: DINOv2's interpolate_pos_encoding (scale_factor =
    (dst + 0.1) / src, bicubic, antialias off)."""
    dst_h, dst_w = dst_hw
    cls_tok, patch = pos_embed[:, :1], pos_embed[:, 1:]
    dim = patch.shape[-1]
    if src_grid * src_grid != patch.shape[1]:
        raise ValueError("pos_embed is not a square grid")
    if (dst_h, dst_w) == (src_grid, src_grid):
        return pos_embed
    grid = patch.reshape(1, src_grid, src_grid, dim).permute(0, 3, 1, 2)
    out = torch.nn.functional.interpolate(
        grid.float(), mode="bicubic", antialias=False,
        scale_factor=(float(dst_h + offset) / src_grid,
                      float(dst_w + offset) / src_grid))
    if tuple(out.shape[-2:]) != (dst_h, dst_w):
        raise ValueError(f"resized position grid is {tuple(out.shape[-2:])}")
    resized = out.permute(0, 2, 3, 1).reshape(1, dst_h * dst_w, dim)
    return torch.cat([cls_tok, resized], dim=1)


def convert_hub_state_dict(sd: dict, image_size: int = 224,
                           cfg: DinoV2Config = VIT_S14) -> dict:
    """torch-hub DINOv2 state dict (torch tensors or numpy arrays) -> the
    state dict of the port's DinoViT at `image_size`."""
    def t(key):
        v = sd[key]
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.asarray(v))
        return v.detach().to("cpu", torch.float32)

    g = image_size // cfg.patch_size
    # conv [C, 3, P, P] -> Linear weight [C, P*P*3] over patches flattened
    # in (ph, pw, 3) order
    conv_w = t("patch_embed.proj.weight")
    out = {
        "cls_token": t("cls_token"),
        "pos_embed": resize_pos_embed(t("pos_embed"), cfg.pretrain_grid,
                                      (g, g)),
        "patch_embed.weight": conv_w.permute(0, 2, 3, 1).reshape(
            cfg.embed_dim, -1),
        "patch_embed.bias": t("patch_embed.proj.bias"),
        "norm.weight": t("norm.weight"), "norm.bias": t("norm.bias"),
    }
    hub_names = {"norm1": "norm1", "norm2": "norm2", "attn.qkv": "attn.qkv",
                 "attn.proj": "attn.proj", "mlp_fc1": "mlp.fc1",
                 "mlp_fc2": "mlp.fc2"}
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        for ours, theirs in hub_names.items():
            for leaf in ("weight", "bias"):
                out[f"{p}{ours}.{leaf}"] = t(f"{p}{theirs}.{leaf}")
        out[p + "ls1"] = t(p + "ls1.gamma")
        out[p + "ls2"] = t(p + "ls2.gamma")
    return {k: v.contiguous().clone() for k, v in out.items()}


def load_backbone(path: Optional[str], image_size: int,
                  cfg: DinoV2Config = VIT_S14) -> Optional[dict]:
    """Backbone state dict for DinoViT from a torch-hub DINOv2 `.pth`
    (converted on the fly) or a file of the port holding a backbone state
    dict (optionally under the key "backbone"). None -> None: the caller
    falls back to random weights, with a warning."""
    if path is None:
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "backbone"):
        if key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    if "patch_embed.proj.weight" in sd:
        return convert_hub_state_dict(sd, image_size, cfg)
    if "patch_embed.weight" not in sd:
        raise ValueError(f"{path}: neither a torch-hub DINOv2 state dict nor "
                         "a backbone state dict of this package")
    return {k: v.to(torch.float32) for k, v in sd.items()}
