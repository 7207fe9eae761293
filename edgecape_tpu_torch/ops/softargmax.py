"""Soft-argmax keypoint proposals (global + local 3x3 window);
counterpart of edgecape_tpu/ops/softargmax.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_center_grid(h: int, w: int, device=None) -> torch.Tensor:
    """[h, w, 2] grid of (x, y) pixel-centre coordinates."""
    ys = torch.linspace(0.5, h - 0.5, h, dtype=torch.float32, device=device)
    xs = torch.linspace(0.5, w - 0.5, w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _expect(probs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    grid = pixel_center_grid(h, w, probs.device).reshape(h * w, 2)
    coords = torch.matmul(probs, grid)
    return coords / torch.tensor([w, h], dtype=torch.float32,
                                 device=probs.device)


def global_soft_argmax(similarity: torch.Tensor, h: int,
                       w: int) -> torch.Tensor:
    """[B, K, h*w] logits -> [B, K, 2] expected (x, y) / (w, h)."""
    return _expect(torch.softmax(similarity, dim=-1), h, w)


def local_soft_argmax(similarity: torch.Tensor, h: int, w: int,
                      window: int = 3) -> torch.Tensor:
    """Global-softmax probabilities masked to the window x window patch
    around the argmax, re-normalised, soft-argmaxed."""
    b, k, _ = similarity.shape
    probs = torch.softmax(similarity, dim=-1)
    max_idx = torch.argmax(similarity, dim=-1)
    one_hot = F.one_hot(max_idx, h * w).to(torch.float32)
    pad = window // 2
    mask = F.max_pool2d(one_hot.reshape(b * k, 1, h, w), window, stride=1,
                        padding=pad).reshape(b, k, h * w)
    local = probs * mask
    local = local / (local.sum(dim=-1, keepdim=True) + 1e-10)
    return _expect(local, h, w)
