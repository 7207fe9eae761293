"""High-level estimator: backbone + head; counterpart of
edgecape_tpu/api.py:PoseEstimator on one device. It takes no mesh: a
torch process drives one card, so the JAX estimator's in-process mesh
branches (batches padded and sharded over local devices) have no
counterpart; several cards evaluate as one process each, the episodes
sharded and the records gathered by eval/runner.py (parallel/).

Entry points:
* `forward_cached`: the support context is computed once per episode
  group, gathered onto each query row by `group`, and the query phase
  runs in `head_dtype` (head parameters and the support context cast at
  the boundary, scores, soft-argmax and the coordinate trajectory kept
  fp32 inside the modules); predictions come back fp32;
* `forward_batch`: one episode per row (an EpisodeBatch with rendered
  support heatmaps), support and query images through the backbone
  together; returns the predictions, the predicted adjacency and the
  point trajectory;
* `forward_debug`: as forward_batch but always on the plain modules,
  returning the similarity maps and the decoder's cross-attention maps;
* `decode_batch`: normalised predictions to original-image coordinates
  and result records (numpy, on the host).

With `use_flash` (resolved to True on a CUDA device) the eval path runs
the hand-written kernels: the bf16 backbone through fused_vit_block (or
fused_vit_block2 per pair of blocks), an fp32 backbone's attention
through flash_mha, the skeleton's keypoint
self-attention through flash_mha, the joint encoder through
fused_encoder_stack and the decoder through fused_decoder_layer per layer
(or fused_decoder_stack as a whole); ops/kernel_config.py holds the two
variant switches. Built for a CUDA device with the kernels on, a model
whose widths the kernels do not take raises before anything is built
(kernel_config.require_widths). An explicit use_flash=False with float32
compute and head dtype is the strict path: plain modules, and on a CUDA
device TF32 switched off for its matmuls and convolutions."""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch

from .models import dinov2
from .models.convert import init_params
from .models.edgecape import HEAD_OPS, EdgeCape, SupportContext
from .ops import heatmap
from .ops.affine import transform_preds_batch
from .ops.kernel_config import require_widths
from .staging import HostStager

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


@contextlib.contextmanager
def strict_fp32():
    """Full-precision float32 on the card for the strict path: TF32 off
    for matmuls and for cuDNN while the block runs (cuDNN's default is
    on), and the settings restored after it."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


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
        # host arrays reach the device through pinned buffers (CUDA only)
        self._stage = HostStager(self.device)
        flash = cfg.model.use_flash
        self.use_flash = bool(self.device.type == "cuda" if flash is None
                              else flash)
        if self.use_flash:
            misfits = dinov2.width_misfits(cfg.model, backbone_cfg)
            require_widths(dinov2.fused_ops(cfg.model) + HEAD_OPS, misfits,
                           self.device)
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
        self.head, self.query_head = self.make_heads(head_state)
        self.strict = (not self.use_flash
                       and self.compute_dtype == torch.float32
                       and self.head_dtype == torch.float32)

    def _precision(self):
        """The context a forward runs in: strict_fp32 on the strict path."""
        return strict_fp32() if self.strict else contextlib.nullcontext()

    def make_heads(self, head_state: dict):
        """(head, query_head): new head modules on the estimator's device
        holding head_state, the second in the head dtype (the first itself
        at fp32). The live ones are not touched: a server builds a
        reloaded head aside and swaps it in whole."""
        head = EdgeCape(self.cfg.model, use_flash=self.use_flash,
                        device=self.device)
        head.load_state_dict(head_state)
        head.to(self.device).eval()
        query_head = head if self.head_dtype == torch.float32 \
            else copy.deepcopy(head).to(self.head_dtype)
        return head, query_head

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
        t = self._stage
        with torch.no_grad(), self._precision():
            ctx = self.support_context(t(support["img_s"], "img_s"),
                                       t(support["joints_s"], "joints_s"),
                                       t(support["vis_s"], "vis_s"),
                                       t(support["binary_adj"], "binary_adj"))
            group = t(query["group"], "group").long()
            ctx_rows = SupportContext(*(None if a is None else a[group]
                                        for a in ctx))
            pred = self.query_rows(ctx_rows, t(query["img_q"], "img_q"))
        return pred, ctx_rows.raw_adj

    # ---------------------------------------------------- uncached paths
    def _batch_tensors(self, batch):
        t = self._stage
        return (t(batch.img_s, "img_s"), t(batch.img_q, "img_q"),
                t(batch.target_s, "target_s"), t(batch.weight_s, "weight_s"),
                t(batch.binary_adj, "binary_adj"))

    def _encode_batch(self, img_s, img_q, target_s, weight_s, binary_adj,
                      *, backbone, use_flash: bool):
        """Backbone over support and query images together; returns the
        head's inputs (feat_q, feat_s, target_s, mask_s, binary_adj).
        Images arrive normalised."""
        b, s = img_s.shape[:2]
        imgs = torch.cat([img_s.reshape((b * s,) + img_s.shape[2:]), img_q],
                         dim=0)
        feats = dinov2.extract_features(backbone, imgs,
                                        dtype=self.compute_dtype,
                                        use_flash=use_flash)
        feat_s = feats[:b * s].reshape((b, s) + feats.shape[1:])
        mask_s = torch.prod(weight_s, dim=1)
        return feats[b * s:], feat_s, target_s, mask_s, binary_adj

    def forward_batch(self, batch):
        """batch: an EpisodeBatch (img_s [B, S, H, W, 3], img_q
        [B, H, W, 3], both normalised; target_s [B, S, K, h, w]; weight_s
        [B, S, K]; binary_adj [B, K, K]). Returns (pred_norm [B, K, 2] in
        [0, 1], raw_adj [B, K, K], trajectory [L+1, B, K, 2]) on the
        estimator's device."""
        with torch.no_grad(), self._precision():
            args = self._encode_batch(*self._batch_tensors(batch),
                                      backbone=self.backbone,
                                      use_flash=self.use_flash)
            out = self.head(*args)
            traj = torch.stack([out.encode.proposals] + list(out.points[1:]),
                               dim=0)
        return out.outputs[-1], out.encode.raw_adj, traj

    def forward_debug(self, batch):
        """The debug forward, always on the plain modules (no kernel op,
        whatever use_flash says): returns (pred_norm [B, K, 2], raw_adj,
        similarity [B, K, gh, gw], attn_maps [L, B, K, HW]), the last
        being the decoder's kp->image cross-attention probabilities
        averaged over heads."""
        backbone, head = self.backbone, self.head
        if self.use_flash:
            # the same weights on modules built without the kernel routes
            if getattr(self, "_debug_modules", None) is None:
                self._debug_modules = (
                    dinov2.DinoViT(self.backbone_cfg,
                                   self.cfg.model.image_size).to(
                        self.device, self.compute_dtype).eval(),
                    EdgeCape(self.cfg.model).to(self.device).eval())
            backbone, head = self._debug_modules
            backbone.load_state_dict(self.backbone.state_dict())
            head.load_state_dict(self.head.state_dict())
        with torch.no_grad(), self._precision():
            args = self._encode_batch(*self._batch_tensors(batch),
                                      backbone=backbone, use_flash=False)
            enc = head.encode(*args)
            outputs, _, attn = head.decode(
                enc.kp_tokens, enc.img_tokens, enc.proposals, enc.adj,
                enc.hop_stack, enc.kp_valid, enc.img_pos, return_attn=True)
        return outputs[-1], enc.raw_adj, enc.similarity, attn

    # ------------------------------------------------------------ decode
    def decode_batch(self, pred_norm, batch) -> dict:
        """Normalised predictions -> original-image coordinates and
        result records (the reference's head.decode)."""
        size = self.cfg.model.image_size
        if isinstance(pred_norm, torch.Tensor):
            pred_norm = pred_norm.detach().cpu().numpy()
        coords = np.asarray(pred_norm) * size
        centers = batch.meta["query_center"]
        scales = batch.meta["query_scale"]
        preds_img = transform_preds_batch(
            coords, centers, scales, (size, size),
            use_udp=self.cfg.test_data.use_udp)
        b, k = coords.shape[:2]
        all_preds = np.zeros((b, k, 3), np.float32)
        all_preds[:, :, :2] = preds_img
        all_preds[:, :, 2] = 1.0
        boxes = np.zeros((b, 6), np.float32)
        boxes[:, 0:2] = centers
        boxes[:, 2:4] = scales
        boxes[:, 4] = np.prod(scales * 200.0, axis=1)
        boxes[:, 5] = 1.0
        return {"preds": all_preds, "boxes": boxes,
                "image_paths": batch.meta["query_image_file"],
                "bbox_ids": batch.meta["bbox_id"]}
