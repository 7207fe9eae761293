"""High-level estimator: backbone + head, cached-support eval forward;
counterpart of edgecape_tpu/api.py:PoseEstimator.forward_cached.

The support context is computed once per episode group, gathered onto
each query row by `group`, and the query phase runs in `head_dtype`
(head parameters and the support context cast at the boundary, scores,
soft-argmax and the coordinate trajectory kept fp32 inside the modules);
predictions come back fp32. With `use_flash` (resolved to True on a CUDA
device) the eval path runs the hand-written kernels: the bf16 backbone
through fused_vit_block, the skeleton's keypoint self-attention through
flash_mha, the joint encoder through fused_encoder_stack and each decoder
layer through fused_decoder_layer."""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from .models import dinov2
from .models.convert import init_params
from .models.edgecape import EdgeCape, SupportContext
from .ops import heatmap

# ImageNet statistics, as in edgecape_tpu/ops/warp.py
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def maybe_normalize(imgs: torch.Tensor) -> torch.Tensor:
    """uint8 images -> ImageNet-normalised float32; floats pass through
    (they arrive normalised)."""
    if imgs.dtype == torch.uint8:
        mean = torch.as_tensor(IMAGENET_MEAN, device=imgs.device)
        std = torch.as_tensor(IMAGENET_STD, device=imgs.device)
        return (imgs.to(torch.float32) / 255.0 - mean) / std
    return imgs


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the
    caller names another; asking for CUDA without one is an error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless "
                           "it is given device=\"cpu\"")
    return device


def _cast_floats(ctx: SupportContext, dtype) -> SupportContext:
    return SupportContext(*(
        t.to(dtype) if t is not None and t.is_floating_point() else t
        for t in ctx))


class PoseEstimator:
    """Inference wrapper around a DinoViT trunk and an EdgeCape head.

    cfg: an object with `model` and `test_data` attributes carrying the
    fields of edgecape_tpu.config's ModelConfig and DataConfig (read by
    attribute; an edgecape_tpu Config works as it is). backbone_state /
    head_state: state dicts (convert.from_jax_params or
    convert.init_params); when absent they are drawn by init_params from
    `generator` (seed 0 by default). cfg.model.use_flash None means:
    kernels on a CUDA device, plain modules on the CPU; an explicit False
    is the strict path. Runs on the CUDA device unless `device` says
    otherwise, and raises without one."""

    def __init__(self, cfg, backbone_state: Optional[dict] = None,
                 head_state: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda",
                 backbone_cfg: dinov2.DinoV2Config = dinov2.VIT_S14):
        self.device = resolve_device(device)
        flash = cfg.model.use_flash
        self.use_flash = bool(self.device.type == "cuda" if flash is None
                              else flash)
        self.cfg = cfg
        self.backbone_cfg = backbone_cfg
        if backbone_state is None or head_state is None:
            g = generator if generator is not None else \
                torch.Generator().manual_seed(0)
            bb, hd = init_params(g, cfg.model, backbone_cfg)
            backbone_state = bb if backbone_state is None else backbone_state
            head_state = hd if head_state is None else head_state
        self.backbone = dinov2.DinoViT(backbone_cfg, cfg.model.image_size,
                                       use_flash=self.use_flash)
        self.backbone.load_state_dict(backbone_state)
        self.compute_dtype = _DTYPES[cfg.model.compute_dtype]
        self.head_dtype = _DTYPES[cfg.model.head_dtype]
        # the fused fast path reads the fp32 parameters; the plain trunk
        # runs in the compute dtype
        bb_dtype = torch.float32 if self.use_flash else self.compute_dtype
        self.backbone.to(self.device, bb_dtype).eval()
        self.head = EdgeCape(cfg.model, use_flash=self.use_flash)
        self.head.load_state_dict(head_state)
        self.head.to(self.device).eval()
        self.query_head = self.head if self.head_dtype == torch.float32 \
            else copy.deepcopy(self.head).to(self.head_dtype)

    def load_head_state(self, head_state: dict) -> None:
        """Swap other head weights in (the trainer's eval hook does so
        with the live ones)."""
        self.head.load_state_dict(head_state)
        if self.query_head is not self.head:
            self.query_head = copy.deepcopy(self.head).to(self.head_dtype)

    # ------------------------------------------------------- two phases
    def support_context(self, img_s, joints_s, vis_s,
                        binary_adj) -> SupportContext:
        """img_s [G, S, H, W, 3] (uint8 or normalised float); joints_s
        [G, S, K, 2] model-input pixels; vis_s [G, S, K]; binary_adj
        [G, K, K]."""
        m = self.cfg.model
        td = self.cfg.test_data
        if td.use_udp:
            render = heatmap.render_udp
        elif getattr(td, "unbiased_encoding", False):
            render = heatmap.render_msra_unbiased
        else:
            render = heatmap.render_msra
        g, s = img_s.shape[:2]
        imgs = maybe_normalize(img_s.reshape((g * s,) + img_s.shape[2:]))
        feats = dinov2.extract_features(self.backbone, imgs,
                                        dtype=self.compute_dtype,
                                        use_flash=self.use_flash)
        feat_s = feats.reshape((g, s) + feats.shape[1:])
        size = float(m.image_size)
        target_s, weight_s = render(joints_s, vis_s,
                                    (m.heatmap_size, m.heatmap_size),
                                    (size, size), td.sigma)
        mask_s = torch.prod(weight_s[..., 0], dim=1)
        return self.head.encode_support(feat_s, target_s, mask_s,
                                        binary_adj)

    def query_rows(self, ctx_rows: SupportContext, img_q) -> torch.Tensor:
        """Query phase on a context already gathered per row; returns the
        last layer's normalised predictions [Nq, K, 2] fp32."""
        feat_q = dinov2.extract_features(self.backbone,
                                         maybe_normalize(img_q),
                                         dtype=self.compute_dtype,
                                         use_flash=self.use_flash)
        head = self.query_head
        if self.head_dtype != torch.float32:
            ctx_rows = _cast_floats(ctx_rows, self.head_dtype)
            feat_q = feat_q.to(self.head_dtype)
        enc = head.encode_query(feat_q, ctx_rows)
        outputs, _ = head.decode(enc.kp_tokens, enc.img_tokens,
                                 enc.proposals, enc.adj, enc.hop_stack,
                                 enc.kp_valid, enc.img_pos)
        return outputs[-1].to(torch.float32)

    # ------------------------------------------------------ cached path
    def forward_cached(self, support: dict, query: dict):
        """support: img_s, joints_s, vis_s, binary_adj ([G, ...]); query:
        img_q [Nq, ...], group [Nq]. Returns (pred_norm [Nq, K, 2] fp32,
        raw_adj [Nq, K, K]) on the estimator's device; the work is queued
        on the device and not waited for."""
        dev = self.device

        def t(a):
            return torch.as_tensor(a).to(dev, non_blocking=True)

        with torch.no_grad():
            ctx = self.support_context(t(support["img_s"]),
                                       t(support["joints_s"]),
                                       t(support["vis_s"]),
                                       t(support["binary_adj"]))
            group = t(query["group"]).long()
            ctx_rows = SupportContext(*(None if a is None else a[group]
                                        for a in ctx))
            pred = self.query_rows(ctx_rows, t(query["img_q"]))
        return pred, ctx_rows.raw_adj
