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

`convert_head` / `convert_full` read the reference's own checkpoints
(EdgeCape on mmpose: the head under `keypoint_head_module.*`, the
torch-hub DINOv2 under `encoder_query.*`): the head's names are mapped
as the JAX package's edgecape_tpu/models/convert.py maps them (this is
its copy, kept equal by tests), onto a flax-shaped tree that
`state_from_flax` turns into the port's state dict. Both layouts of
torch.nn.MultiheadAttention (a fused in_proj_weight, separate
q/k/v_proj_weight for kdim/vdim) and the fairseq-style split q/k/v of
the reference's BiasedMultiheadAttention are read.
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


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


class _SD:
    """Accessor over a flat reference state dict (flax-shaped leaves)."""

    def __init__(self, sd: dict):
        self.sd = sd

    def has(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str) -> np.ndarray:
        return _np(self.sd[key])

    def linear(self, prefix: str) -> dict:
        return {"kernel": self.get(prefix + ".weight").T,
                "bias": self.get(prefix + ".bias")}

    def ln(self, prefix: str) -> dict:
        return {"scale": self.get(prefix + ".weight"),
                "bias": self.get(prefix + ".bias")}

    def conv1x1(self, prefix: str) -> dict:
        """Conv2d / Conv1d of kernel 1 -> Dense."""
        w = self.get(prefix + ".weight")
        w = w.reshape(w.shape[0], w.shape[1])                 # [out, in]
        return {"kernel": w.T, "bias": self.get(prefix + ".bias")}

    def mha(self, prefix: str, embed_dim: int) -> dict:
        """torch.nn.MultiheadAttention (fused or separate projections) or
        fairseq-style split projections -> q/k/v/out projections."""
        d = embed_dim
        if self.has(prefix + ".in_proj_weight"):
            w = self.get(prefix + ".in_proj_weight")
            b = self.get(prefix + ".in_proj_bias")
            qw, kw, vw = w[:d], w[d:2 * d], w[2 * d:]
            qb, kb, vb = b[:d], b[d:2 * d], b[2 * d:]
        elif self.has(prefix + ".q_proj_weight"):
            qw = self.get(prefix + ".q_proj_weight")
            kw = self.get(prefix + ".k_proj_weight")
            vw = self.get(prefix + ".v_proj_weight")
            b = self.get(prefix + ".in_proj_bias")
            qb, kb, vb = b[:d], b[d:2 * d], b[2 * d:]
        else:
            qw, qb = (self.get(prefix + ".q_proj.weight"),
                      self.get(prefix + ".q_proj.bias"))
            kw, kb = (self.get(prefix + ".k_proj.weight"),
                      self.get(prefix + ".k_proj.bias"))
            vw, vb = (self.get(prefix + ".v_proj.weight"),
                      self.get(prefix + ".v_proj.bias"))
        return {"q_proj": {"kernel": qw.T, "bias": qb},
                "k_proj": {"kernel": kw.T, "bias": kb},
                "v_proj": {"kernel": vw.T, "bias": vb},
                "out_proj": self.linear(prefix + ".out_proj")}


def _decoder_layer(sd: _SD, p: str, cfg, *, two_way: bool,
                   with_bias_mlp: bool) -> dict:
    d = cfg.d_model
    out = {
        "self_attn": sd.mha(p + "self_attn", d),
        "cross_attn": sd.mha(p + "multihead_attn", 2 * d),
        "choker": sd.linear(p + "choker"),
        "gcn": {"conv": sd.conv1x1(p + "ffn1.conv")},
        "ffn2": sd.linear(p + "ffn2"),
        "norm1": sd.ln(p + "norm1"),
        "norm2": sd.ln(p + "norm2"),
        "norm3": sd.ln(p + "norm3"),
    }
    if two_way:
        out["two_way_attn"] = sd.mha(p + "cross_attn_image_to_token", 2 * d)
        out["two_way_choker"] = sd.linear(
            p + "cross_attn_image_to_token_choker")
        out["norm4"] = sd.ln(p + "norm4")
    if with_bias_mlp and sd.has(
            p + "self_attn.markov_structural_mlp.0.weight"):
        # torchvision MLP: [Linear, ReLU, Dropout, Linear, Dropout]
        out["bias_mlp"] = {
            "fc1": sd.linear(p + "self_attn.markov_structural_mlp.0"),
            "fc2": sd.linear(p + "self_attn.markov_structural_mlp.3"),
        }
    return out


def _head_tree(sd_raw: dict, cfg) -> dict:
    """Reference `keypoint_head_module.*` -> the head's flax-shaped tree
    (the JAX package's convert_head)."""
    kh = "keypoint_head_module."
    sd = _SD({k[len(kh):]: v for k, v in sd_raw.items()
              if k.startswith(kh)})
    t = "transformer."
    params: dict = {
        "input_proj": sd.conv1x1("input_proj"),
        "query_proj": sd.linear("query_proj"),
        "mask_token": sd.get(t + "mask_token"),
    }
    for i in range(cfg.num_encoder_layers):
        p = f"{t}encoder.layers.{i}."
        params[f"enc{i}"] = {
            "self_attn": sd.mha(p + "self_attn", cfg.d_model),
            "linear1": sd.linear(p + "linear1"),
            "linear2": sd.linear(p + "linear2"),
            "norm1": sd.ln(p + "norm1"),
            "norm2": sd.ln(p + "norm2"),
        }
    pg = t + "proposal_generator."
    params["proposal_gen"] = {
        "support_proj": sd.linear(pg + "support_proj"),
        "query_proj": sd.linear(pg + "query_proj"),
        "dynamic_fc1": sd.linear(pg + "dynamic_proj.0"),
        "dynamic_fc2": sd.linear(pg + "dynamic_proj.2"),
    }
    dec: dict = {
        "norm": sd.ln(t + "decoder.norm"),
        "ref_point_head": {
            "fc1": sd.linear(t + "decoder.ref_point_head.layers.0"),
            "fc2": sd.linear(t + "decoder.ref_point_head.layers.1"),
        },
    }
    for i in range(cfg.num_decoder_layers):
        dec[f"layer{i}"] = _decoder_layer(
            sd, f"{t}decoder.layers.{i}.", cfg, two_way=False,
            with_bias_mlp=cfg.attn_bias)
        # kpt branch: Sequential [L, G, L, G, L, G, L] -> indices 0, 2, 4, 6
        kb = f"kpt_branch.{i}.mlp."
        dec[f"kpt_branch{i}"] = {
            "fc0": sd.linear(kb + "0"), "fc1": sd.linear(kb + "2"),
            "fc2": sd.linear(kb + "4"), "out": sd.linear(kb + "6"),
        }
    params["decoder"] = dec
    sk: dict = {}
    if sd.has("skeleton_head.image_project.weight"):
        sk["image_project"] = sd.conv1x1("skeleton_head.image_project")
    for i in range(cfg.skeleton_num_layers):
        p = f"skeleton_head.skeleton_predictor.{i}."
        if sd.has(p + "choker.weight"):
            sk[f"refine{i}"] = _decoder_layer(sd, p, cfg, two_way=True,
                                              with_bias_mlp=False)
    if sd.has("skeleton_head.zero_conv.weight"):
        sk["zero_conv_w"] = sd.get(
            "skeleton_head.zero_conv.weight").reshape(1)
        sk["zero_conv_b"] = sd.get("skeleton_head.zero_conv.bias")
    if sk:
        params["skeleton"] = sk
    return params


def convert_head(sd_raw: dict, cfg) -> dict:
    """The reference's state dict (its `keypoint_head_module.*` entries)
    -> the state dict of the port's EdgeCape for `cfg` (a ModelConfig of
    the checkpoint's curriculum stage)."""
    return state_from_flax(_head_tree(sd_raw, cfg))


def convert_full(sd_raw: dict, cfg, image_size: Optional[int] = None,
                 backbone_cfg: DinoV2Config = VIT_S14):
    """A full reference checkpoint (optionally under "state_dict") ->
    (backbone state dict for DinoViT at image_size, or None when it holds
    no backbone; head state dict for EdgeCape)."""
    if "state_dict" in sd_raw:
        sd_raw = sd_raw["state_dict"]
    head = convert_head(sd_raw, cfg)
    backbone = None
    for prefix in ("encoder_query.", "encoder_sample."):
        bb = {k[len(prefix):]: v for k, v in sd_raw.items()
              if k.startswith(prefix)}
        if bb:
            backbone = convert_hub_state_dict(
                bb, image_size or cfg.image_size, backbone_cfg)
            break
    return backbone, head


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
