"""Gaussian keypoint-heatmap rendering; counterpart of
edgecape_tpu/ops/heatmap.py. All three encodings are here, MSRA (the
default), MSRA unbiased and UDP, each twice: `render_*` on tensors (the
`render_*_jnp` device functions of the JAX module, used by the cached
eval) and `render_*_np` on numpy arrays, one keypoint set at a time (the
JAX module's host renderers, called by data/pipeline.py)."""

from __future__ import annotations

import numpy as np
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


# ------------------------------------------------ host (numpy) renderers
def _msra_centers(joints_xy: np.ndarray, feat_stride: np.ndarray) -> np.ndarray:
    # int(v + 0.5) truncates toward zero after adding 0.5.
    return np.trunc(joints_xy / feat_stride + 0.5).astype(np.int64)


def render_msra_np(joints_xy, visible, heatmap_size, image_size, sigma: float):
    """MSRA truncated-gaussian targets, vectorized.

    Args:
      joints_xy: [K, 2] keypoint coords in input-image pixels.
      visible: [K] visibility (>0 means labeled).
      heatmap_size: (W, H).
      image_size: (W, H) of the model input.
      sigma: gaussian sigma in heatmap pixels.

    Returns:
      target [K, H, W] float32, weight [K, 1] float32.

    Semantics:
    center snapped to int(x/stride + 0.5); gaussian truncated to a
    (6*sigma+1)^2 window with peak value 1; weight zeroed when the window
    falls fully outside the map.
    """
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    joints_xy = np.asarray(joints_xy, dtype=np.float32)
    K = joints_xy.shape[0]
    feat_stride = np.asarray(image_size, dtype=np.float32) / np.array(
        [W, H], dtype=np.float32)
    tmp_size = sigma * 3

    mu = _msra_centers(joints_xy[:, :2], feat_stride)  # [K, 2] int
    # window bounds: int() truncation toward zero of mu -/+ ts —
    # matters when 3*sigma is fractional (asymmetric window, and the
    # gaussian anchors at ul + (2*ts+1)//2 rather than at mu)
    ul = np.trunc(mu - tmp_size)
    br = np.trunc(mu + tmp_size + 1)
    in_bounds = ~((ul[:, 0] >= W) | (ul[:, 1] >= H) | (br[:, 0] < 0)
                  | (br[:, 1] < 0))

    weight = (np.asarray(visible, dtype=np.float32).reshape(K)
              * in_bounds.astype(np.float32)).reshape(K, 1)

    x0 = (2.0 * tmp_size + 1.0) // 2.0
    center = ul + x0                                      # [K, 2]
    xs = np.arange(W, dtype=np.float32)[None, None, :]   # [1, 1, W]
    ys = np.arange(H, dtype=np.float32)[None, :, None]   # [1, H, 1]
    dx = xs - center[:, 0].astype(np.float32)[:, None, None]
    dy = ys - center[:, 1].astype(np.float32)[:, None, None]
    g = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    window = ((xs >= ul[:, 0][:, None, None])
              & (xs < br[:, 0][:, None, None])
              & (ys >= ul[:, 1][:, None, None])
              & (ys < br[:, 1][:, None, None]))
    draw = (weight[:, 0] > 0.5)[:, None, None]
    target = (g * window * draw).astype(np.float32)
    return target, weight.astype(np.float32)


def render_udp_np(joints_xy, visible, heatmap_size, image_size, sigma: float):
    """UDP GaussianHeatMap targets: continuous sub-pixel center, stride
    (size-1)/(hsize-1). Args/returns match render_msra_np."""
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    joints_xy = np.asarray(joints_xy, dtype=np.float32)
    K = joints_xy.shape[0]
    feat_stride = ((np.asarray(image_size, dtype=np.float32) - 1.0)
                   / (np.array([W, H], dtype=np.float32) - 1.0))
    tmp_size = sigma * 3

    mu_ac = joints_xy[:, :2] / feat_stride          # continuous center
    mu = np.trunc(mu_ac + 0.5)                      # snapped (window anchor)
    ul = np.trunc(mu - tmp_size)
    br = np.trunc(mu + tmp_size + 1)
    in_bounds = ~((ul[:, 0] >= W) | (ul[:, 1] >= H) | (br[:, 0] < 0)
                  | (br[:, 1] < 0))
    weight = (np.asarray(visible, dtype=np.float32).reshape(K)
              * in_bounds.astype(np.float32)).reshape(K, 1)

    # gaussian anchor:
    # x0 = size//2 + (mu_ac - mu) relative to ul
    x0 = (2.0 * tmp_size + 1.0) // 2.0
    center = ul + x0 + (mu_ac - mu)
    xs = np.arange(W, dtype=np.float32)[None, None, :]
    ys = np.arange(H, dtype=np.float32)[None, :, None]
    dx = xs - center[:, 0][:, None, None]
    dy = ys - center[:, 1][:, None, None]
    g = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    window = ((xs >= ul[:, 0][:, None, None])
              & (xs < br[:, 0][:, None, None])
              & (ys >= ul[:, 1][:, None, None])
              & (ys < br[:, 1][:, None, None]))
    draw = (weight[:, 0] > 0.5)[:, None, None]
    target = (g * window * draw).astype(np.float32)
    return target, weight.astype(np.float32)


def render_msra_unbiased_np(joints_xy, visible, heatmap_size, image_size,
                         sigma: float):
    """MSRA targets with `unbiased_encoding=True` (Dark-pose style): the
    gaussian is centered at
    the CONTINUOUS sub-pixel coordinate, drawn over the full map (no
    window truncation), and the in-bounds check uses float window bounds
    (no int() snapping).

    Args/returns match render_msra_np.
    """
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    joints_xy = np.asarray(joints_xy, dtype=np.float32)
    K = joints_xy.shape[0]
    feat_stride = np.asarray(image_size, dtype=np.float32) / np.array(
        [W, H], dtype=np.float32)
    tmp_size = sigma * 3

    mu = joints_xy[:, :2] / feat_stride               # [K, 2] continuous
    ul = mu - tmp_size                                # float bounds
    br = mu + tmp_size + 1
    in_bounds = ~((ul[:, 0] >= W) | (ul[:, 1] >= H) | (br[:, 0] < 0)
                  | (br[:, 1] < 0))
    weight = (np.asarray(visible, dtype=np.float32).reshape(K)
              * in_bounds.astype(np.float32)).reshape(K, 1)

    xs = np.arange(W, dtype=np.float32)[None, None, :]
    ys = np.arange(H, dtype=np.float32)[None, :, None]
    dx = xs - mu[:, 0][:, None, None]
    dy = ys - mu[:, 1][:, None, None]
    g = np.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    draw = (weight[:, 0] > 0.5)[:, None, None]
    return (g * draw).astype(np.float32), weight.astype(np.float32)
