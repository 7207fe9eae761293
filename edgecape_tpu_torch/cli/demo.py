"""Demo CLI of the port: one-shot keypoint transfer between two images;
counterpart of demo.py.

The support annotation comes from a JSON file (the headless equivalent of
clicking):

  {"keypoints": [[x, y], ...], "skeleton": [[i, j], ...]}   # 0-indexed,
  pixel coords on the original support image.

Both images go through the demo preprocessing: square-pad to the long
side (bottom and right), resize to --size (default 256), ImageNet
normalize; support heatmaps are rasterized with sigma=2. The model is the
stage-3 EdgeCape (learned skeleton, Markov bias, the bias attention
module, K = 100) over DINOv2 ViT-S/14 in fp32, on the kernels on the card.
Writes a 3-panel visualization with the learned adjacency rendered as
edge widths (utils/visualization.py, which needs matplotlib).

    python -m edgecape_tpu_torch.cli.demo --support S.png --query Q.png \\
        --annotation ann.json [--checkpoint CKPT] [--device cpu]

Runs on the CUDA device and raises without one; `--device cpu` is the
only way onto the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np


def _resize_axis(img: np.ndarray, size: int, axis: int) -> np.ndarray:
    """Linear resampling of float32 `img` along `axis` to `size` samples
    with the half-pixel rule of cv2's INTER_LINEAR: output sample i reads
    the source at (i + 0.5) * n / size - 0.5, clamped to the edge."""
    n = img.shape[axis]
    src = (np.arange(size, dtype=np.float64) + 0.5) * (n / size) - 0.5
    src = np.clip(src, 0.0, n - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    w = (src - lo).astype(np.float32)
    shape = [1] * img.ndim
    shape[axis] = size
    w = w.reshape(shape)
    return (np.take(img, lo, axis=axis) * (1.0 - w)
            + np.take(img, hi, axis=axis) * w)


def square_pad_resize(img: np.ndarray, size: int):
    """Pad to square (bottom/right, top-left anchored), then a bilinear
    resize to size x size (cv2.INTER_LINEAR's sampling, in float32 and
    rounded once, where cv2 sums 11-bit fixed-point weights: the two
    differ by at most one intensity level). Returns (uint8 image, scale);
    points map as p' = p * scale."""
    h, w = img.shape[:2]
    side = max(h, w)
    padded = np.zeros((side, side, 3), np.uint8)
    padded[:h, :w] = img
    out = _resize_axis(padded.astype(np.float32), size, 1)
    out = _resize_axis(out, size, 0)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8), \
        size / side


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> ImageNet-normalised float32."""
    from ..ops.warp import IMAGENET_MEAN, IMAGENET_STD
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def stage3_config(size: int = 256, max_kpt: int = 100,
                  use_flash: Optional[bool] = None):
    """The Config of stage3_estimator's model."""
    from ..config import Config, ModelConfig
    return Config(model=ModelConfig(
        image_size=size, max_kpt=max_kpt, learn_skeleton=True,
        attn_bias=True, use_bias_attn_module=True, use_flash=use_flash))


def stage3_estimator(size: int = 256, max_kpt: int = 100, *,
                     checkpoint: Optional[str] = None,
                     backbone_ckpt: Optional[str] = None,
                     backbone_state: Optional[dict] = None,
                     head_state: Optional[dict] = None,
                     use_flash: Optional[bool] = None, device="cuda"):
    """The demo's and the server's PoseEstimator: the stage-3 EdgeCape
    (learned skeleton, Markov bias, the bias attention module) at `size`
    px with `max_kpt` keypoints, every other field of ModelConfig at its
    default (fp32 compute and head dtype). Head weights from a checkpoint
    of the port's trainer (`checkpoint`) or a state dict (`head_state`),
    backbone weights from a torch-hub DINOv2 file or a backbone state dict
    of the port (`backbone_ckpt`, models/convert.load_backbone) or a state
    dict (`backbone_state`); what is not given is drawn from seed 0.
    use_flash None: the kernels on a CUDA device."""
    from ..api import PoseEstimator
    from ..models.convert import load_backbone
    from ..train import checkpoint as ck

    if checkpoint:
        tree = ck.load_checkpoint(checkpoint)
        head_state = tree.get("model", tree)
    if backbone_ckpt:
        backbone_state = load_backbone(backbone_ckpt, size)
    return PoseEstimator(stage3_config(size, max_kpt, use_flash),
                         backbone_state, head_state, device=device)


def infer(est, support_img: np.ndarray, query_img: np.ndarray,
          annotation: dict, *, debug: bool = False) -> dict:
    """The demo's inference on an estimator built by stage3_estimator.
    Images are RGB uint8 arrays; annotation holds original-pixel keypoints
    and the skeleton. Returns a dict of host arrays: `pred_px` [k, 2]
    query keypoints in model-input pixels and `raw_adj` [k, k] the learned
    adjacency over the k annotated keypoints; `batch` (the EpisodeBatch
    that went through forward_batch), `support` / `query` (normalised
    model inputs), `joints` / `visible` (support keypoints in model-input
    pixels), `skeleton`; with `debug`, `similarity` [K, gh, gw] and
    `attn` [L, K, HW] of forward_debug on the same batch."""
    import torch

    from ..data.mp100 import EpisodeBatch
    from ..ops import heatmap

    m = est.cfg.model
    size, k_max = m.image_size, m.max_kpt
    kpts = np.asarray(annotation["keypoints"], np.float32).reshape(-1, 2)
    skeleton = [[int(i), int(j)] for i, j in annotation.get("skeleton", [])]
    k_real = len(kpts)
    if k_real > k_max:
        raise ValueError(f"the annotation has {k_real} keypoints; the model "
                         f"takes at most {k_max}")

    sup, s_scale = square_pad_resize(support_img, size)
    qry, _ = square_pad_resize(query_img, size)
    visible = np.zeros(k_max, np.float32)
    visible[:k_real] = 1.0
    joints = np.zeros((k_max, 2), np.float32)
    joints[:k_real] = kpts * s_scale
    target, weight = heatmap.render_msra_np(
        joints, visible, (m.heatmap_size, m.heatmap_size), (size, size),
        sigma=2)
    adj = np.zeros((k_max, k_max), np.float32)
    for i, j in skeleton:
        if i < k_max and j < k_max:
            adj[i, j] = adj[j, i] = 1.0

    sup_n, qry_n = normalize(sup), normalize(qry)
    batch = EpisodeBatch(
        img_s=sup_n[None, None], target_s=target[None, None],
        weight_s=weight[:, 0][None, None], img_q=qry_n[None],
        target_q=np.zeros_like(target)[None], weight_q=visible[None],
        joints_q=np.zeros((1, k_max, 2), np.float32), binary_adj=adj[None],
        rand_mask=np.ones((1, k_max), np.float32),
        meta={"query_center": np.array([[size / 2, size / 2]]),
              "query_scale": np.array([[size / 200, size / 200]]),
              "query_image_file": ["query"], "bbox_id": [0]})
    pred_norm, raw_adj, _ = est.forward_batch(batch)
    out = {"pred_px": pred_norm[0, :k_real].cpu().numpy() * size,
           "raw_adj": raw_adj[0, :k_real, :k_real].cpu().numpy(),
           "batch": batch, "support": sup_n, "query": qry_n,
           "joints": joints[:k_real], "visible": visible[:k_real],
           "skeleton": skeleton, "adj": adj[:k_real, :k_real]}
    if debug:
        _, _, similarity, attn = est.forward_debug(batch)
        out["similarity"] = similarity[0].to(torch.float32).cpu().numpy()
        out["attn"] = attn[:, 0].to(torch.float32).cpu().numpy()
    return out


def run_inference(support_img: np.ndarray, query_img: np.ndarray,
                  annotation: dict, *, checkpoint=None, backbone_ckpt=None,
                  size: int = 256, out_dir: str = "demo_out",
                  plot_similarity: bool = False,
                  plot_attention: bool = False, device="cuda"):
    """Inference and its figure, used by the CLI and the gradio app.
    Images are RGB uint8 arrays; annotation holds original-pixel
    keypoints and the skeleton. Returns the visualization file path."""
    from ..utils.visualization import (plot_attn, plot_results,
                                       plot_similarity_maps)

    est = stage3_estimator(size, checkpoint=checkpoint,
                           backbone_ckpt=backbone_ckpt, device=device)
    res = infer(est, support_img, query_img, annotation,
                debug=plot_similarity or plot_attention)
    kis = list(range(min(len(res["joints"]), 6)))
    if plot_similarity:
        plot_similarity_maps(res["query"], res["similarity"], kis, out_dir)
    if plot_attention:
        plot_attn(res["query"], res["attn"], kis, out_dir,
                  gt_adj=res["adj"], learned_adj=res["raw_adj"])
    return plot_results(res["support"], res["query"], res["joints"],
                        res["visible"], res["pred_px"], res["skeleton"],
                        res["raw_adj"], out_dir)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.cli.demo",
        description="EdgeCape demo (PyTorch + CUDA port)")
    p.add_argument("--support", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--annotation", required=True,
                   help="JSON with support keypoints + skeleton")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file of the port's trainer")
    p.add_argument("--backbone-ckpt", default=None,
                   help="torch-hub DINOv2 .pth, or a backbone state dict "
                   "saved by this package")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--plot-similarity", action="store_true",
                   help="also render per-keypoint similarity maps")
    p.add_argument("--plot-attn", action="store_true",
                   help="also render per-layer decoder attention maps")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..api import resolve_device
    from ..data.pipeline import load_image

    device = resolve_device(args.device)
    with open(args.annotation) as f:
        ann = json.load(f)
    path = run_inference(load_image(args.support), load_image(args.query),
                         ann, checkpoint=args.checkpoint,
                         backbone_ckpt=args.backbone_ckpt, size=args.size,
                         out_dir=args.out,
                         plot_similarity=args.plot_similarity,
                         plot_attention=args.plot_attn, device=device)
    print("wrote", path)
    return path


if __name__ == "__main__":
    main()
