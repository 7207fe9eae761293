"""Bounding-box affine geometry on the host (numpy); counterpart of
edgecape_tpu/ops/affine.py.

The top-down crop geometry without cv2: the 2x3 matrices are solved
directly from the three point correspondences, matching
cv2.getAffineTransform to float precision. `transform_preds_batch` maps
model-space coordinates back to original-image pixels through the
closed-form inverse of the rot=0 crop."""

from __future__ import annotations

import numpy as np

PIXEL_STD = 200.0


def xywh2cs(x: float, y: float, w: float, h: float, *, image_size,
            padding: float = 1.25) -> tuple[np.ndarray, np.ndarray]:
    """Encode a COCO xywh bbox into (center, scale): aspect-ratio fix to
    the model input ratio, pixel-std 200, x1.25 context padding."""
    aspect_ratio = float(image_size[0]) / float(image_size[1])
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / PIXEL_STD, h / PIXEL_STD], dtype=np.float32) * padding
    return center, scale


def _rotate(pt, rad):
    sn, cs = np.sin(rad), np.cos(rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs],
                    dtype=np.float32)


def _third_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 2x3 affine from three point pairs (equivalent of
    cv2.getAffineTransform)."""
    ones = np.ones((3, 1), dtype=np.float64)
    A = np.concatenate([src.astype(np.float64), ones], axis=1)  # [3, 3]
    M = np.linalg.solve(A, dst.astype(np.float64))  # [3, 2]
    return M.T.astype(np.float64)  # [2, 3]


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0),
                         inv: bool = False) -> np.ndarray:
    """2x3 matrix mapping the (center, scale, rot) box onto output_size.

    Triangle construction: src = [center, center + rot(0, -boxw/2), third],
    dst likewise around the output center.
    """
    center = np.asarray(center, dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    scale_px = scale * PIXEL_STD
    shift = np.asarray(shift, dtype=np.float32)
    src_w = scale_px[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    src_dir = _rotate([0.0, src_w * -0.5], np.pi * rot / 180.0)
    dst_dir = np.array([0.0, dst_w * -0.5], dtype=np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + scale_px * shift
    src[1] = center + src_dir + scale_px * shift
    src[2] = _third_point(src[0], src[1])

    dst = np.zeros((3, 2), dtype=np.float32)
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform_points(pts: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to [..., 2] points."""
    pts = np.asarray(pts, dtype=np.float64)
    return pts @ mat[:, :2].T + mat[:, 2]


def get_warp_matrix_udp(rot: float, center, output_size,
                        scale_px) -> np.ndarray:
    """UDP ('unbiased data processing') warp matrix.

    Maps the (center, scale, rot) box onto [0, output_size-1] with unit
    half-pixel alignment (the use_udp path calls it as
    get_warp_matrix(r, c*2, image_size-1, s*200)). Derivation: rotate about
    the box center, scale by (dst)/(box), translate so the box center lands
    on the dst center.

    Args:
      rot: degrees. center: (x, y) box center. output_size: (w-1, h-1) of
      the destination. scale_px: box size in pixels (w, h).
    """
    theta = np.deg2rad(rot)
    size_input = np.asarray(center, np.float64) * 2.0
    size_dst = np.asarray(output_size, np.float64)
    size_target = np.asarray(scale_px, np.float64)
    m = np.zeros((2, 3), np.float64)
    scale_x = size_dst[0] / size_target[0]
    scale_y = size_dst[1] / size_target[1]
    c, s = np.cos(theta), np.sin(theta)
    m[0, 0] = c * scale_x
    m[0, 1] = -s * scale_x
    m[0, 2] = scale_x * (-0.5 * size_input[0] * c
                         + 0.5 * size_input[1] * s + 0.5 * size_target[0])
    m[1, 0] = s * scale_y
    m[1, 1] = c * scale_y
    m[1, 2] = scale_y * (-0.5 * size_input[0] * s
                         - 0.5 * size_input[1] * c + 0.5 * size_target[1])
    return m


def transform_preds(coords: np.ndarray, center, scale, output_size,
                    use_udp: bool = False) -> np.ndarray:
    """Map model-space coords [K, 2] back to original image coords.

    Closed form of the inverse rot=0 crop affine.
    """
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(scale, dtype=np.float64) * PIXEL_STD
    out = np.asarray(output_size, dtype=np.float64)
    if use_udp:
        factor = scale / (out - 1.0)
    else:
        factor = scale / out
    target = np.asarray(coords, dtype=np.float64).copy()
    target[..., 0] = coords[..., 0] * factor[0] + center[0] - scale[0] * 0.5
    target[..., 1] = coords[..., 1] * factor[1] + center[1] - scale[1] * 0.5
    return target


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
