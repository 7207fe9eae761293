"""On-device Gaussian keypoint-heatmap rendering; counterpart of the
`render_*_jnp` functions of edgecape_tpu/ops/heatmap.py. All three
encodings the cached eval can select are here: MSRA (the default),
MSRA unbiased and UDP."""

from __future__ import annotations

import torch


def _grids(heatmap_size, device):
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    xs = torch.arange(w, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)
    return w, h, xs, ys


def _stride(image_size, w, h, device, udp: bool):
    size = torch.tensor(image_size, dtype=torch.float32, device=device)
    hm = torch.tensor([w, h], dtype=torch.float32, device=device)
    return (size - 1.0) / (hm - 1.0) if udp else size / hm


def _in_bounds(ul, br, w, h):
    return ~((ul[..., 0] >= w) | (ul[..., 1] >= h) | (br[..., 0] < 0)
             | (br[..., 1] < 0))


def _window(xs, ys, ul, br):
    return ((xs[None, :] >= ul[..., 0][..., None, None])
            & (xs[None, :] < br[..., 0][..., None, None])
            & (ys[:, None] >= ul[..., 1][..., None, None])
            & (ys[:, None] < br[..., 1][..., None, None]))


def _gauss(xs, ys, center, sigma):
    dx = xs[None, :] - center[..., 0][..., None, None]
    dy = ys[:, None] - center[..., 1][..., None, None]
    return torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))


def render_msra(joints_xy, visible, heatmap_size, image_size, sigma: float):
    """joints_xy [..., K, 2], visible [..., K] ->
    (target [..., K, H, W], weight [..., K, 1]): truncated gaussian at the
    snapped integer centre (render_msra_jnp)."""
    w, h, xs, ys = _grids(heatmap_size, joints_xy.device)
    stride = _stride(image_size, w, h, joints_xy.device, udp=False)
    tmp = sigma * 3
    mu = torch.trunc(joints_xy / stride + 0.5)
    ul = torch.trunc(mu - tmp)
    br = torch.trunc(mu + tmp + 1)
    weight = visible.to(torch.float32) * _in_bounds(ul, br, w, h).float()
    center = ul + (2.0 * tmp + 1.0) // 2.0
    g = _gauss(xs, ys, center, sigma)
    draw = (weight > 0.5)[..., None, None]
    target = g * _window(xs, ys, ul, br) * draw
    return target.to(torch.float32), weight[..., None]


def render_msra_unbiased(joints_xy, visible, heatmap_size, image_size,
                         sigma: float):
    """Continuous sub-pixel centre, no window (render_msra_unbiased_jnp)."""
    w, h, xs, ys = _grids(heatmap_size, joints_xy.device)
    stride = _stride(image_size, w, h, joints_xy.device, udp=False)
    tmp = sigma * 3
    mu = joints_xy / stride
    weight = visible.to(torch.float32) * _in_bounds(
        mu - tmp, mu + tmp + 1, w, h).float()
    draw = (weight > 0.5)[..., None, None]
    return (_gauss(xs, ys, mu, sigma) * draw).to(torch.float32), \
        weight[..., None]


def render_udp(joints_xy, visible, heatmap_size, image_size, sigma: float):
    """UDP: continuous centre, window anchored at the snapped centre
    (render_udp_jnp)."""
    w, h, xs, ys = _grids(heatmap_size, joints_xy.device)
    stride = _stride(image_size, w, h, joints_xy.device, udp=True)
    tmp = sigma * 3
    mu_ac = joints_xy / stride
    mu = torch.trunc(mu_ac + 0.5)
    ul = torch.trunc(mu - tmp)
    br = torch.trunc(mu + tmp + 1)
    weight = visible.to(torch.float32) * _in_bounds(ul, br, w, h).float()
    center = ul + (2.0 * tmp + 1.0) // 2.0 + (mu_ac - mu)
    g = _gauss(xs, ys, center, sigma)
    draw = (weight > 0.5)[..., None, None]
    return (g * _window(xs, ys, ul, br) * draw).to(torch.float32), \
        weight[..., None]
