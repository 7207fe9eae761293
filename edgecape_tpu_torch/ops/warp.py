"""Batched affine image warping on tensors (crop + resize + normalize);
counterpart of edgecape_tpu/ops/warp.py. Plain PyTorch, as the JAX
function is plain XLA.

cv2.warpAffine(INTER_LINEAR) semantics: dst(x, y) = bilinear(src, M_inv @
(x, y, 1)) with zero padding outside; sampling positions are pixel indices
(not centers), matching cv2's convention.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def invert_affine(mat: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine (dst->src matrix from a src->dst one)."""
    A = np.asarray(mat, dtype=np.float64)
    Ainv = np.linalg.inv(np.vstack([A, [0.0, 0.0, 1.0]]))
    return Ainv[:2]


def warp_affine_batch(images: torch.Tensor, inv_mats: torch.Tensor,
                      out_hw: tuple, normalize: bool = True) -> torch.Tensor:
    """Batched affine warp + optional ImageNet normalization.

    images: [B, H, W, 3] uint8 or float (0..255); inv_mats: [B, 2, 3]
    dst->src affine matrices (see invert_affine); out_hw: (h, w).
    Returns [B, h, w, 3] float32.
    """
    h, w = out_hw
    dev = images.device
    b, H, W = images.shape[:3]
    img = images.to(torch.float32)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    dst = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)      # [h, w, 3]
    src = torch.einsum("hwk,bjk->bhwj", dst,
                       inv_mats.to(device=dev, dtype=torch.float32))
    x, y = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    bi = torch.arange(b, device=dev)[:, None, None]

    def gather(yi, xi):
        inside = ((xi >= 0) & (xi <= W - 1) & (yi >= 0)
                  & (yi <= H - 1))[..., None]
        return img[bi, yi.clamp(0, H - 1), xi.clamp(0, W - 1)] * inside

    top = gather(y0i, x0i) * (1 - fx) + gather(y0i, x0i + 1) * fx
    bot = gather(y0i + 1, x0i) * (1 - fx) + gather(y0i + 1, x0i + 1) * fx
    out = top * (1 - fy) + bot * fy
    if normalize:
        mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
        std = torch.from_numpy(IMAGENET_STD).to(dev)
        out = (out / 255.0 - mean) / std
    return out
