"""Per-sample preprocessing: load -> (augment) -> affine crop -> normalize
-> heatmap targets; counterpart of edgecape_tpu/data/pipeline.py.

The train / valid pipeline: load the image (RGB), random scale and
rotation (rot +-2*15 deg w.p. 0.6, scale +-0.15, the only train
augmentation), affine crop to the model input, ImageNet normalization,
MSRA heatmap targets (sigma 1).

The warp runs through the C++ core (data/native.py) on every machine, so
a machine without cv2 computes the same pixels as one with it; against
cv2.warpAffine(INTER_LINEAR) the core differs by cv2's fixed-point
rounding (at most 4/255, median 1/255).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..ops import affine, heatmap
from ..ops.warp import IMAGENET_MEAN, IMAGENET_STD, invert_affine
from . import native


@dataclasses.dataclass
class Sample:
    """One preprocessed instance (support or query)."""
    img: np.ndarray          # [H, W, 3] float32 normalized, or uint8
    target: np.ndarray       # [K, h, w] heatmaps
    target_weight: np.ndarray  # [K]
    joints: np.ndarray       # [K, 2] model-input pixel coords
    joints_visible: np.ndarray  # [K]
    center: np.ndarray
    scale: np.ndarray
    rotation: float


def _read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6, 8 bits per channel) with numpy alone."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:                  # magic, width, height, maxval
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":       # comment to the end of the line
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    pos += 1                                # the one whitespace byte
    if fields[0] != b"P6" or int(fields[3]) != 255:
        raise ValueError(f"{path}: only binary 8-bit PPM (P6, maxval 255) "
                         "is read without an image library")
    w, h = int(fields[1]), int(fields[2])
    return np.frombuffer(data, np.uint8, count=h * w * 3,
                         offset=pos).reshape(h, w, 3).copy()


def load_image(path: str) -> np.ndarray:
    """RGB uint8 image [H, W, 3]. `.npy` arrays and binary PPM are read
    with numpy alone; every other format needs cv2 or PIL."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        img = np.load(path)
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"{path}: expected a uint8 [H, W, 3] array, "
                             f"got {img.dtype} {img.shape}")
        return img
    if ext in (".ppm", ".pnm"):
        return _read_ppm(path)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"{path}: cv2 could not decode the image")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{path}: decoding {ext or 'this'} images needs cv2 "
            "(opencv-python) or PIL (pillow), and neither can be imported; "
            "only .npy and binary .ppm are read without them") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def random_scale_rotation(scale, cfg, rng: np.random.Generator):
    """Scale jitter from a clipped normal, rotation applied with
    probability rot_prob."""
    sf, rf = cfg.scale_factor, cfg.rot_factor
    s = scale * np.clip(rng.standard_normal() * sf + 1, 1 - sf, 1 + sf)
    if rng.random() <= cfg.rot_prob:
        r = float(np.clip(rng.standard_normal() * rf, -rf * 2, rf * 2))
    else:
        r = 0.0
    return s, r


def crop_geometry(record: dict, cfg, center, scale, rot):
    """(forward 2x3 matrix, transformed joints [K, 2], visible [K]) of one
    db record under (center, scale, rot): the UDP branch transforms all
    joints through the half-pixel-aligned matrix, the default one only
    the visible joints."""
    joints = np.asarray(record["joints_3d"], np.float32)[:, :2]
    visible = (np.asarray(record["joints_3d_visible"], np.float32)[:, 0]
               > 0).astype(np.float32)
    size = cfg.image_size
    if cfg.use_udp:
        mat = affine.get_warp_matrix_udp(rot, center, (size - 1.0, size - 1.0),
                                         scale * 200.0)
        joints_t = affine.affine_transform_points(joints, mat).astype(
            np.float32)
    else:
        mat = affine.get_affine_transform(center, scale, rot, (size, size))
        joints_t = joints.copy()
        vis_mask = visible > 0
        joints_t[vis_mask] = affine.affine_transform_points(
            joints[vis_mask], mat)
    return mat, joints_t, visible


def preprocess(record: dict, cfg, *, augment: bool = False,
               rng: Optional[np.random.Generator] = None,
               image: Optional[np.ndarray] = None,
               with_target: bool = True,
               normalize: bool = True) -> Sample:
    """record: db entry with image_file/center/scale/joints_3d/
    joints_3d_visible (see mp100.build_db). with_target=False skips host
    heatmap rendering (the device-render paths only need joints);
    normalize=False returns the warped image as uint8."""
    img = image if image is not None else load_image(record["image_file"])
    center = np.asarray(record["center"], np.float32)
    scale = np.asarray(record["scale"], np.float32)
    rot = float(record.get("rotation", 0))
    if augment and rng is not None:
        scale, rot = random_scale_rotation(scale, cfg, rng)

    size = (cfg.image_size, cfg.image_size)
    mat, joints_t, visible = crop_geometry(record, cfg, center, scale, rot)
    inv = invert_affine(mat)[None].astype(np.float32)
    if normalize:
        img_out = native.warp_normalize_batch([img], inv, size, IMAGENET_MEAN,
                                              IMAGENET_STD, 1)[0]
    else:
        img_out = native.warp_uint8_batch([img], inv, size, 1)[0]

    if with_target:
        if cfg.use_udp:
            render = heatmap.render_udp_np
        elif getattr(cfg, "unbiased_encoding", False):
            render = heatmap.render_msra_unbiased_np
        else:
            render = heatmap.render_msra_np
        target, weight = render(joints_t, visible,
                                (cfg.heatmap_size, cfg.heatmap_size), size,
                                cfg.sigma)
    else:
        target = np.zeros((len(joints_t), 0, 0), np.float32)
        weight = visible[:, None].copy()
    return Sample(img=img_out, target=target, target_weight=weight[:, 0],
                  joints=joints_t, joints_visible=visible, center=center,
                  scale=scale, rotation=rot)
