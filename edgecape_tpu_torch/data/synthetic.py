"""Synthetic MP-100 stand-in: procedurally generated categories with
keypoints + skeletons, written as COCO json + PPM images; counterpart of
edgecape_tpu/data/synthetic.py.

A structurally identical dataset (category metadata with skeleton edge
lists, per-instance bboxes and keypoints, multiple instances per
category) that lets the full pipeline (COCO index, episodic sampling,
warps, heatmaps, eval protocol, training) run end to end without MP-100.
Each category is a distinct rigid polygon 'species'; an instance is that
polygon under a random similarity transform, drawn onto a textured
background, keypoints at its vertices.

The same seed gives the same categories, skeletons and annotations as the
JAX package's generator (the random draws are made in the same order);
only the image files differ: drawn with numpy and written as binary PPM,
which the loader reads without an image library.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _category_shape(rng: np.random.Generator, num_kpt: int) -> np.ndarray:
    """Canonical keypoint layout for a category: noisy ring, radius ~1."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, size=num_kpt))
    radii = rng.uniform(0.5, 1.0, size=num_kpt)
    return np.stack([radii * np.cos(angles), radii * np.sin(angles)], -1)


def _chain_skeleton(num_kpt: int, rng: np.random.Generator):
    edges = [[i, i + 1] for i in range(num_kpt - 1)]
    # a few random chords so graphs differ in structure
    for _ in range(max(1, num_kpt // 4)):
        i, j = rng.choice(num_kpt, size=2, replace=False)
        if [int(i), int(j)] not in edges and [int(j), int(i)] not in edges:
            edges.append([int(min(i, j)), int(max(i, j))])
    return edges


def _disc(canvas: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    h, w = canvas.shape[:2]
    y0, y1 = max(0, cy - radius), min(h, cy + radius + 1)
    x0, x1 = max(0, cx - radius), min(w, cx + radius + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= radius * radius
    canvas[y0:y1, x0:x1][mask] = color


def _line(canvas: np.ndarray, p0, p1, color, radius: int = 1) -> None:
    """A thick segment: discs along it, one per pixel step."""
    steps = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    for t in np.linspace(0.0, 1.0, steps):
        _disc(canvas, int(round(p0[0] + t * (p1[0] - p0[0]))),
              int(round(p0[1] + t * (p1[1] - p0[1]))), radius, color)


def write_ppm(path: str, img: np.ndarray) -> None:
    """uint8 RGB [H, W, 3] as a binary PPM."""
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def generate(root: str, *, num_classes: int = 10,
             images_per_class: int = 30, image_size: int = 320,
             seed: int = 0, split_name: str = "synth") -> str:
    """Create the dataset under `root`; returns the annotation json path."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    categories, images, annotations = [], [], []
    img_id, ann_id = 0, 0
    for cid in range(1, num_classes + 1):
        num_kpt = int(rng.integers(5, 16))
        canon = _category_shape(rng, num_kpt)
        skeleton = _chain_skeleton(num_kpt, rng)
        categories.append({
            "id": cid, "name": f"species_{cid}",
            "keypoints": [f"kp_{i}" for i in range(num_kpt)],
            "skeleton": skeleton,
        })
        for _ in range(images_per_class):
            fname = f"img_{img_id:06d}.ppm"
            canvas = rng.integers(0, 80, size=(image_size, image_size, 3),
                                  dtype=np.uint8)
            # random similarity transform of the canonical shape
            theta = rng.uniform(0, 2 * np.pi)
            s = rng.uniform(0.15, 0.35) * image_size
            cx, cy = rng.uniform(0.3, 0.7, size=2) * image_size
            R = np.array([[np.cos(theta), -np.sin(theta)],
                          [np.sin(theta), np.cos(theta)]])
            pts = canon @ R.T * s + np.array([cx, cy])
            color = tuple(int(v) for v in rng.integers(100, 255, size=3))
            ipts = pts.astype(int)
            for i, j in skeleton:
                _line(canvas, ipts[i], ipts[j], color)
            for p in ipts:
                _disc(canvas, int(p[0]), int(p[1]), 4, color)
            write_ppm(os.path.join(img_dir, fname), canvas)

            vis = ((pts[:, 0] >= 0) & (pts[:, 0] < image_size)
                   & (pts[:, 1] >= 0) & (pts[:, 1] < image_size))
            kpts = np.concatenate(
                [pts, np.where(vis, 2.0, 0.0)[:, None]], axis=1)
            x0, y0 = pts.min(0) - 10
            x1, y1 = pts.max(0) + 10
            bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
            images.append({"id": img_id, "file_name": fname,
                           "width": image_size, "height": image_size})
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": cid,
                "bbox": bbox, "area": bbox[2] * bbox[3], "iscrowd": 0,
                "keypoints": [float(v) for v in kpts.reshape(-1)],
                "num_keypoints": int(vis.sum()),
            })
            img_id += 1
            ann_id += 1

    ann_path = os.path.join(ann_dir, f"mp100_{split_name}.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    return ann_path
