"""Support-keypoint feature pooling; counterpart of
edgecape_tpu/models/head.py:pool_support_keypoints."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] matrix of jax.image.resize(..., 'linear') along one axis,
    built in float32 the way jax's compute_weight_mat builds it: a
    triangle kernel at the sample positions, widened by the scale when
    downsampling (antialias), columns normalised, samples outside the
    input zeroed."""
    f32 = np.float32
    scale = f32(dst) / f32(src)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = (np.abs(sample_f[None, :] - np.arange(src, dtype=f32)[:, None])
         / kernel_scale)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    return np.ascontiguousarray(weights.T)


def pool_support_keypoints(support_feats: torch.Tensor,
                           support_heatmaps: torch.Tensor) -> torch.Tensor:
    """Heatmap-weighted pooling of support features per keypoint.

    support_feats [B, S, gh, gw, C]; support_heatmaps [B, S, K, H, W] ->
    [B, K, C], averaged over shots. The sum-normalised heatmap is taken
    down to the feature grid through the transpose of the bilinear
    upsampler (the adjoint form of upsample-then-pool; exactly equal)."""
    b, s, gh, gw, c = support_feats.shape
    _, _, k, hh, hw = support_heatmaps.shape
    dev = support_feats.device
    hm = support_heatmaps.reshape(b, s, k, hh * hw)
    hm = (hm / (hm.sum(dim=-1, keepdim=True) + 1e-8)).reshape(b, s, k, hh, hw)
    uy = torch.from_numpy(bilinear_matrix(gh, hh)).to(dev)     # [hh, gh]
    ux = torch.from_numpy(bilinear_matrix(gw, hw)).to(dev)     # [hw, gw]
    hm_small = torch.einsum("Yy,bskYX,Xx->bskyx", uy, hm.to(torch.float32),
                            ux)
    pooled = torch.einsum("bskyx,bsyxc->bskc", hm_small,
                          support_feats.to(torch.float32))
    return pooled.mean(dim=1).to(support_feats.dtype)
