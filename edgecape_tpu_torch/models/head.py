"""Support-keypoint feature pooling and the training losses; counterpart
of edgecape_tpu/models/head.py. Pure functions over batched tensors."""

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


@functools.lru_cache(maxsize=None)
def torch_bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] matrix of F.interpolate(..., 'bilinear',
    align_corners=False) along one axis: no anti-aliasing when
    downsampling, each output sample a 2-tap interpolation at
    (i + 0.5) * src / dst - 0.5 clamped at 0."""
    scale = src / dst
    x = np.maximum((np.arange(dst) + 0.5) * scale - 0.5, 0.0)
    lo = np.minimum(np.floor(x).astype(np.int64), src - 1)
    hi = np.minimum(lo + 1, src - 1)
    w = (x - lo).astype(np.float32)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), lo] += 1.0 - w
    m[np.arange(dst), hi] += w
    return m


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """Visibility-normalised L1: per sample, the sum over coordinates and
    joints over the number of visible joints (at least 1), then the mean
    over the batch. pred/target [B, K, 2]; weight [B, K]."""
    per_kp = (pred - target).abs().sum(dim=-1) * weight
    normalizer = weight.sum(dim=-1).clamp(min=1.0)
    return (per_kp.sum(dim=-1) / normalizer).mean()


def reconstruction_loss(recon, target, weight, loss_weight: float):
    """Masked-keypoint reconstruction loss."""
    return masked_l1(recon, target, weight) * loss_weight


def heatmap_mse_loss(similarity, target_heatmap, weight,
                     loss_weight: float) -> torch.Tensor:
    """Auxiliary heatmap loss: MSE between sigmoid(similarity) and the
    max-normalised ground-truth heatmap resized to the similarity grid.
    similarity [B, K, h, w]; target_heatmap [B, K, H, W]; weight [B, K]."""
    b, k, h, w = similarity.shape
    sim = torch.sigmoid(similarity.to(torch.float32))
    hh, hw = target_heatmap.shape[-2:]
    dev = similarity.device
    my = torch.from_numpy(torch_bilinear_matrix(hh, h)).to(dev)
    mx = torch.from_numpy(torch_bilinear_matrix(hw, w)).to(dev)
    tgt = torch.einsum("yY,bkYX,xX->bkyx", my,
                       target_heatmap.to(torch.float32), mx)
    peak = tgt.amax(dim=(-2, -1), keepdim=True)
    tgt = tgt / (peak + 1e-10)
    l2 = ((sim - tgt) ** 2) * weight[:, :, None, None]
    l2 = l2.sum(dim=(-2, -1)) / (h * w)
    normalizer = weight.sum(dim=-1).clamp(min=1.0)
    return (l2.sum(dim=-1) / normalizer).mean() * loss_weight


def pck_counts(pred, target, weight, norm_sizes,
               thr: float = 0.2) -> torch.Tensor:
    """The two sums of the train-time PCK probe, [2] fp32: the per-sample
    share of visible joints whose normalised distance is below thr,
    summed over the samples with at least one visible joint, and the
    number of those samples. The probe is their quotient, so processes
    that each hold a part of the batch add their sums before dividing.
    pred/target [B, K, 2] pixels; weight [B, K]; norm_sizes [B, 2]."""
    dist = torch.linalg.norm((pred - target) / norm_sizes[:, None, :],
                             dim=-1)
    hit = (dist < thr) & (weight > 0)
    per_sample_n = weight.sum(dim=-1)
    acc = hit.sum(dim=-1) / per_sample_n.clamp(min=1.0)
    has = per_sample_n > 0
    return torch.stack([(acc * has).sum(), has.sum().to(acc.dtype)])


def pck_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """The probe from pck_counts' sums: 0 when no sample has a visible
    joint."""
    mean = counts[0] / counts[1].clamp(min=1)
    return torch.where(counts[1] > 0, mean, torch.zeros_like(mean))


def pck_accuracy(pred, target, weight, norm_sizes,
                 thr: float = 0.2) -> torch.Tensor:
    """Train-time PCK probe: the share of visible joints whose normalised
    distance is below thr, averaged over joints, then over the samples
    with at least one visible joint. pred/target [B, K, 2] pixels; weight
    [B, K]; norm_sizes [B, 2]."""
    return pck_from_counts(pck_counts(pred, target, weight, norm_sizes, thr))


def keypoint_losses(outputs, targets_norm, weight, *,
                    proposals_for_loss=None, recon=None,
                    skeleton_loss_weight: float = 1.0, similarity=None,
                    target_heatmap=None, with_heatmap_loss: bool = False,
                    heatmap_loss_weight: float = 2.0) -> dict:
    """The loss dict. outputs [L, B, K, 2] per-decoder-layer normalised
    predictions; targets_norm [B, K, 2] ground truth over the image size;
    weight [B, K] visibility (query and all supports)."""
    losses = {}
    if recon is not None:
        losses["adj_reconstruct_loss"] = reconstruction_loss(
            recon, targets_norm, weight, skeleton_loss_weight)
    if with_heatmap_loss and similarity is not None:
        losses["heatmap_loss"] = heatmap_mse_loss(
            similarity, target_heatmap, weight, heatmap_loss_weight)
    if proposals_for_loss is not None:
        losses["proposal_loss"] = masked_l1(proposals_for_loss, targets_norm,
                                            weight)
    for idx in range(outputs.shape[0]):
        losses[f"l1_loss_layer{idx}"] = masked_l1(outputs[idx], targets_norm,
                                                  weight)
    return losses
