"""Host-side decode geometry (numpy): the jax-free twin of
`transform_preds_batch` in edgecape_tpu/ops/affine.py, which maps
model-space coordinates back to original-image pixels through the
closed-form inverse of the rot=0 top-down crop."""

from __future__ import annotations

import numpy as np

PIXEL_STD = 200.0


def transform_preds_batch(coords: np.ndarray, centers: np.ndarray,
                          scales: np.ndarray, output_size,
                          use_udp: bool = False) -> np.ndarray:
    """coords [B, K, 2] in model-input pixels; centers/scales [B, 2]."""
    centers = np.asarray(centers, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64) * PIXEL_STD
    out = np.asarray(output_size, dtype=np.float64)
    if use_udp:
        factor = scales / (out - 1.0)
    else:
        factor = scales / out
    return (np.asarray(coords, dtype=np.float64) * factor[:, None, :]
            + centers[:, None, :] - scales[:, None, :] * 0.5)
