"""DETR-style sine positional encodings (grid + continuous-coordinate
forms); counterpart of edgecape_tpu/ops/pos_enc.py."""

from __future__ import annotations

import math

import torch

TEMPERATURE = 10000.0
SCALE = 2.0 * math.pi
EPS = 1e-6


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Clipped log-odds: the decoder's coordinate-trajectory inverse."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)


def _dim_t(num_feats: int, device=None) -> torch.Tensor:
    i = torch.arange(num_feats, dtype=torch.float32, device=device)
    return TEMPERATURE ** (2.0 * torch.floor(i / 2.0) / num_feats)


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """[..., F] -> (sin(p0), cos(p1), sin(p2), cos(p3), ...)."""
    s = torch.sin(pos[..., 0::2])
    c = torch.cos(pos[..., 1::2])
    return torch.stack([s, c], dim=-1).reshape(*pos.shape[:-1], -1)


def sine_grid(h: int, w: int, num_feats: int = 128,
              device=None) -> torch.Tensor:
    """[h, w, 2*num_feats] sine positional map (normalize=True)."""
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) \
        / (h + EPS) * SCALE
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) \
        / (w + EPS) * SCALE
    dim_t = _dim_t(num_feats, device)
    pos_y = _interleave_sin_cos(y[:, None, None] / dim_t)
    pos_x = _interleave_sin_cos(x[None, :, None] / dim_t)
    pos_y = pos_y.expand(h, w, num_feats)
    pos_x = pos_x.expand(h, w, num_feats)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_coords(coords: torch.Tensor, num_feats: int = 128) -> torch.Tensor:
    """coords [..., 2] normalized (x, y) -> [..., 2*num_feats], ordered
    (y-feats, x-feats); fp32 internally."""
    coords = coords.to(torch.float32)
    x = coords[..., 0] * SCALE
    y = coords[..., 1] * SCALE
    dim_t = _dim_t(num_feats, coords.device)
    pos_x = _interleave_sin_cos(x[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y[..., None] / dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)
