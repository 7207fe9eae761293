"""MP-100 episodic dataset: class-balanced train pairing and seeded val/test
episode generation; counterpart of edgecape_tpu/data/mp100.py, with the
same episodes draw for draw.

The episode index sets follow the MP-100 protocol: CPython's
`random.sample` under the global seeds (`random.seed(1)`,
`np.random.seed(0)` for val / test) over the same per-class object lists.
Episodes are collated host-side into fixed-shape numpy batches
([B, S, ...] supports, K padded to max_kpt, [K, K] adjacency rasterized
from the edge list) ready for one copy to the device. All image warps run
through the C++ core (data/native.py).
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..ops import affine, graph
from ..ops.warp import IMAGENET_MEAN, IMAGENET_STD, invert_affine
from . import native as native_lib
from .coco import CocoIndex
from .pipeline import (crop_geometry, load_image, preprocess,
                       random_scale_rotation)


def build_db(coco: CocoIndex, img_prefix: str, image_size,
             max_kpt: Optional[int], *, check_files: bool = True):
    """Ground-truth records per annotation instance.

    Bbox sanitization, joints padded to max_kpt, center/scale from the
    padded bbox, category skeleton attached.

    check_files: True/"raise" raises on any missing image (episode-parity
    guard, the safe default); "skip" drops the record (shifting subsequent
    obj_ids), as the upstream train dataset does; False never stats, as
    the upstream test dataset.

    Returns (db, cat2obj).
    """
    db = []
    cat2obj = {cid: [] for cid in coco.get_cat_ids()}
    obj_id = 0
    for img_id in coco.get_img_ids():
        info = coco.load_img(img_id)
        width, height = info["width"], info["height"]
        for ann in coco.img_anns(img_id, iscrowd=False):
            if "bbox" not in ann or "keypoints" not in ann:
                continue
            x, y, w, h = ann["bbox"]
            x1, y1 = max(0, x), max(0, y)
            x2 = min(width - 1, x1 + max(0, w - 1))
            y2 = min(height - 1, y1 + max(0, h - 1))
            if not (("area" not in ann or ann["area"] > 0)
                    and x2 > x1 and y2 > y1):
                continue
            if max(ann["keypoints"]) == 0:
                continue
            if ann.get("num_keypoints") == 0:
                continue
            kpts = np.array(ann["keypoints"], np.float32).reshape(-1, 3)
            cat_kpt_num = kpts.shape[0]
            k = max_kpt if max_kpt is not None else cat_kpt_num
            joints = np.zeros((k, 3), np.float32)
            visible = np.zeros((k, 3), np.float32)
            joints[:cat_kpt_num, :2] = kpts[:, :2]
            visible[:cat_kpt_num, :2] = np.minimum(1, kpts[:, 2:3])
            clean_bbox = [x1, y1, x2 - x1, y2 - y1]
            center, scale = affine.xywh2cs(*clean_bbox,
                                           image_size=image_size)
            image_file = os.path.join(img_prefix, info["file_name"])
            if check_files and not os.path.exists(image_file):
                if check_files == "skip":
                    # drop the record. NOTE this shifts every subsequent
                    # obj_id, so seeded episode draws are only comparable
                    # to a run over the SAME partial image set.
                    continue
                # default: fail loudly. A partially downloaded MP-100
                # would otherwise produce plausible but non-comparable
                # PCK numbers with no warning.
                raise FileNotFoundError(
                    f"annotation references missing image {image_file!r}; "
                    "episode parity requires the full image set (or "
                    "check_files='skip' to drop such records, "
                    "check_files=False to defer to load time)")
            cat2obj[ann["category_id"]].append(obj_id)
            db.append({
                "image_file": image_file,
                "center": center,
                "scale": scale,
                "rotation": 0,
                "bbox": clean_bbox,
                "bbox_score": 1,
                "joints_3d": joints,
                "joints_3d_visible": visible,
                "category_id": ann["category_id"],
                "cat_kpt_num": cat_kpt_num,
                "bbox_id": obj_id,
                "skeleton": coco.cats[ann["category_id"]]["skeleton"],
                # PCKh normalization box when the annotation provides it
                # (MP-100 jsons typically omit it)
                "head_size": float(ann.get("head_size", 0.0)),
            })
            obj_id += 1
    return db, cat2obj


@dataclass
class EpisodeBatch:
    """Fixed-shape device-ready arrays + host-side decode metadata."""
    img_s: np.ndarray        # [B, S, H, W, 3]
    target_s: np.ndarray     # [B, S, K, h, w]
    weight_s: np.ndarray     # [B, S, K]
    img_q: np.ndarray        # [B, H, W, 3]
    target_q: np.ndarray     # [B, K, h, w]
    weight_q: np.ndarray     # [B, K]
    joints_q: np.ndarray     # [B, K, 2] model-input pixel coords
    binary_adj: np.ndarray   # [B, K, K]
    rand_mask: np.ndarray    # [B, K] 1 keep / 0 masked (train stage 2)
    joints_s: np.ndarray = None   # [B, S, K, 2] support joints (device
    vis_s: np.ndarray = None      # [B, S, K]    rendering path)
    meta: dict = field(default_factory=dict)


class MP100Dataset:
    """mode: 'train' | 'val' | 'test'."""

    def __init__(self, cfg, mode: str = "train",
                 check_files: bool = True):
        self.cfg = cfg
        self.mode = mode
        self.coco = CocoIndex(cfg.ann_file)
        img_size = (cfg.image_size, cfg.image_size)
        self.db, self.cat2obj = build_db(self.coco, cfg.img_prefix, img_size,
                                         cfg.max_kpt,
                                         check_files=check_files)
        if cfg.valid_class_ids is not None:
            self.valid_class_ids = list(cfg.valid_class_ids)
        else:
            self.valid_class_ids = self.coco.get_cat_ids()
        self.num_shots = cfg.num_shots
        self.img_prefix = cfg.img_prefix if cfg.img_prefix.endswith("/") \
            else cfg.img_prefix + "/"
        self.id2name = {i: im["file_name"] for i, im in self.coco.imgs.items()}
        self.name2id = {v: k for k, v in self.id2name.items()}
        if mode == "train":
            self.resample_episodes()
        else:
            self.make_episodes()

    # ----------------------------------------------------------- episodes
    def resample_episodes(self):
        """Class-balanced random (shots+1)-tuples, reshuffled every epoch
        from the global `random` / `np.random` state."""
        counts = [len(self.cat2obj[c]) for c in self.valid_class_ids]
        max_count = max(counts)
        samples = []
        for cls in self.valid_class_ids:
            pool = self.cat2obj[cls]
            for _ in range(max_count):
                samples.append(random.sample(pool, self.num_shots + 1))
        arr = np.array(samples)
        np.random.shuffle(arr)
        self.paired_samples = arr

    def make_episodes(self):
        """Seeded deterministic episodes (random.seed(1),
        np.random.seed(0)). With cfg.pin_query_images set, only episodes
        whose query is one of the pinned file names are kept (the
        qualitative-figure mode)."""
        random.seed(1)
        np.random.seed(0)
        pinned = None
        if self.cfg.pin_query_images:
            pinned = {os.path.basename(n)
                      for n in self.cfg.pin_query_images}
        samples = []
        for cls in self.valid_class_ids:
            for _ in range(self.cfg.num_episodes):
                drawn = random.sample(self.cat2obj[cls],
                                      self.num_shots + self.cfg.num_queries)
                supports = drawn[:self.num_shots]
                for q in drawn[self.num_shots:]:
                    if pinned is not None:
                        name = os.path.basename(
                            self.db[q]["image_file"])
                        if name not in pinned:
                            continue
                    samples.append(supports + [q])
        self.paired_samples = np.array(samples)

    def __len__(self):
        return len(self.paired_samples)

    # ----------------------------------------------------------- loading
    def _rand_mask(self, joint_weight: np.ndarray, masking_ratio: float,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Zero a random masking_ratio of jointly-visible keypoints
        of the supports. Draws from `rng` when given (per-sample
        determinism for sharded loading), else from global np.random."""
        mask = joint_weight.copy()
        n = int(mask.sum() * masking_ratio)
        idx = np.where(mask == 1)[0]
        perm = (rng.permutation(idx) if rng is not None
                else np.random.permutation(idx))
        mask[perm[:n]] = 0
        return mask

    def get_episode(self, idx: int, *, augment: Optional[bool] = None,
                    rng: Optional[np.random.Generator] = None,
                    masking_ratio: float = 0.0):
        pair = self.paired_samples[idx]
        augment = (self.mode == "train") if augment is None else augment
        supports = [preprocess(self.db[i], self.cfg, augment=augment,
                               rng=rng) for i in pair[:-1]]
        query = preprocess(self.db[pair[-1]], self.cfg, augment=augment,
                           rng=rng)
        skeleton = self.db[pair[0]]["skeleton"]
        return supports, query, skeleton, pair

    # -------------------------------------------------- support grouping
    def support_groups(self):
        """Consecutive episode rows sharing the same support set (val/test
        episodes are generated as num_queries consecutive rows per
        episode). Returns list of (support_ids tuple, [row indices])."""
        groups = []
        cur_key, cur_rows = None, []
        for i, pair in enumerate(self.paired_samples):
            key = tuple(pair[:-1])
            if key != cur_key:
                if cur_rows:
                    groups.append((cur_key, cur_rows))
                cur_key, cur_rows = key, []
            cur_rows.append(i)
        if cur_rows:
            groups.append((cur_key, cur_rows))
        return groups

    def collate_group(self, groups, *, num_threads: int = 8):
        """Collate G support groups + all their queries.

        Returns (support arrays dict [G, ...], query dict with
        [sum(len(rows)), ...] and per-row group index, meta).
        Support images are preprocessed once per group instead of once per
        query; heatmaps are NOT rendered host-side (the device renders
        them from joints); images stay uint8 (ImageNet normalization
        happens on the device: 4x less host->device traffic). Image files
        are read on a thread pool, all warps are one call into the C++
        core.
        """
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        s, k = self.num_shots, cfg.max_kpt
        g = len(groups)
        size = cfg.image_size

        adj = np.zeros((g, k, k), np.float32)
        sup_ids = [sid for ids, _ in groups for sid in ids]
        q_rows = [r for _, rows in groups for r in rows]
        q_ids = [self.paired_samples[r][-1] for r in q_rows]
        group_of_row = np.array([gi for gi, (_, rows) in enumerate(groups)
                                 for _ in rows], np.int32)
        for gi, (ids, _) in enumerate(groups):
            adj[gi] = graph.adjacency_from_edges(
                self.db[ids[0]]["skeleton"], k)

        recs = [self.db[i] for i in sup_ids + q_ids]
        with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
            images = list(pool.map(
                lambda rec: load_image(rec["image_file"]), recs))
        n = len(recs)
        inv_mats = np.zeros((n, 2, 3), np.float32)
        joints = np.zeros((n, k, 2), np.float32)
        vis = np.zeros((n, k), np.float32)
        centers = np.zeros((n, 2), np.float32)
        scales = np.zeros((n, 2), np.float32)
        for i, rec in enumerate(recs):
            centers[i] = np.asarray(rec["center"], np.float32)
            scales[i] = np.asarray(rec["scale"], np.float32)
            mat, joints[i], vis[i] = crop_geometry(
                rec, cfg, centers[i], scales[i],
                float(rec.get("rotation", 0)))
            inv_mats[i] = invert_affine(mat)
        warped = native_lib.warp_uint8_batch(images, inv_mats, (size, size),
                                             num_threads)

        ns = len(sup_ids)
        support = {"img_s": warped[:ns].reshape(g, s, size, size, 3),
                   "binary_adj": adj,
                   "joints_s": joints[:ns].reshape(g, s, k, 2),
                   "vis_s": vis[:ns].reshape(g, s, k)}
        query = {"img_q": warped[ns:], "weight_q": vis[ns:],
                 "joints_q": joints[ns:], "group": group_of_row}
        meta = {"query_center": centers[ns:], "query_scale": scales[ns:],
                "query_image_file": [self.db[q]["image_file"]
                                     for q in q_ids],
                "bbox_id": [int(r) for r in q_rows],
                "category_id": [self.db[q]["category_id"] for q in q_ids]}
        return support, query, meta

    # ------------------------------------------------- native fast path
    def collate_native(self, indices, *, augment: Optional[bool] = None,
                       rng: Optional[np.random.Generator] = None,
                       masking_ratio: float = 0.0,
                       num_threads: int = 0) -> EpisodeBatch:
        """Batched collate through the C++ preprocessing core
        (csrc/preprocess.cc): one multithreaded call for all warps and
        one for all heatmaps, instead of per-image python. The same
        pixels as `collate`; heatmaps equal to float rounding."""
        cfg = self.cfg
        if getattr(cfg, "unbiased_encoding", False) and not cfg.use_udp:
            raise NotImplementedError(
                "the C++ core renders biased-MSRA targets; use collate() "
                "for unbiased_encoding")
        augment = (self.mode == "train") if augment is None else augment
        b, s, k = len(indices), self.num_shots, cfg.max_kpt
        size = cfg.image_size

        images, inv_mats, all_joints, all_vis = [], [], [], []
        metas = []
        per_sample = isinstance(rng, (list, tuple))
        for bi, idx in enumerate(indices):
            ep_rng = rng[bi] if per_sample else rng
            pair = self.paired_samples[idx]
            recs = [self.db[i] for i in pair]
            q_cs = None
            for rec in recs:
                img = load_image(rec["image_file"])
                center = np.asarray(rec["center"], np.float32)
                scale = np.asarray(rec["scale"], np.float32)
                rot = float(rec.get("rotation", 0))
                if augment and ep_rng is not None:
                    scale, rot = random_scale_rotation(scale, cfg, ep_rng)
                mat, jt, vis = crop_geometry(rec, cfg, center, scale, rot)
                images.append(img)
                inv_mats.append(invert_affine(mat))
                all_joints.append(jt)
                all_vis.append(vis)
                q_cs = (center, scale)  # last one is the query's
            metas.append((idx, pair, recs[-1], q_cs))

        warped = native_lib.warp_normalize_batch(
            images, np.stack(inv_mats).astype(np.float32), (size, size),
            IMAGENET_MEAN, IMAGENET_STD, num_threads)
        render = (native_lib.udp_heatmaps_batch if cfg.use_udp
                  else native_lib.msra_heatmaps_batch)
        targets, weights = render(
            np.stack(all_joints), np.stack(all_vis),
            (cfg.heatmap_size, cfg.heatmap_size), (float(size), float(size)),
            cfg.sigma, num_threads)

        warped = warped.reshape(b, s + 1, size, size, 3)
        targets = targets.reshape(b, s + 1, k, cfg.heatmap_size,
                                  cfg.heatmap_size)
        weights = weights.reshape(b, s + 1, k)
        joints_arr = np.stack(all_joints).reshape(b, s + 1, k, 2)
        vis_arr = np.stack(all_vis).reshape(b, s + 1, k)

        adj = np.zeros((b, k, k), np.float32)
        rand_mask = np.ones((b, k), np.float32)
        centers = np.zeros((b, 2), np.float32)
        scales = np.zeros((b, 2), np.float32)
        paths, bbox_ids, cats, pairs = [], [], [], []
        for bi, (idx, pair, qrec, q_cs) in enumerate(metas):
            adj[bi] = graph.adjacency_from_edges(
                self.db[pair[0]]["skeleton"], k)
            if masking_ratio > 0:
                joint_w = weights[bi, :s].prod(axis=0)
                rand_mask[bi] = self._rand_mask(
                    joint_w, masking_ratio,
                    rng=rng[bi] if per_sample else None)
            centers[bi], scales[bi] = q_cs
            paths.append(qrec["image_file"])
            bbox_ids.append(int(idx))
            cats.append(qrec["category_id"])
            pairs.append(pair)

        meta = {"query_center": centers, "query_scale": scales,
                "query_image_file": paths, "bbox_id": bbox_ids,
                "category_id": cats, "pair": pairs}
        return EpisodeBatch(
            img_s=warped[:, :s], target_s=targets[:, :s],
            weight_s=weights[:, :s], img_q=warped[:, s],
            target_q=targets[:, s], weight_q=weights[:, s],
            joints_q=joints_arr[:, s], binary_adj=adj,
            rand_mask=rand_mask, joints_s=joints_arr[:, :s],
            vis_s=vis_arr[:, :s], meta=meta)

    # ----------------------------------------------------------- batching
    def collate(self, indices, *, augment: Optional[bool] = None,
                rng: Optional[np.random.Generator] = None,
                masking_ratio: float = 0.0) -> EpisodeBatch:
        cfg = self.cfg
        b, s, k = len(indices), self.num_shots, cfg.max_kpt
        hs = cfg.heatmap_size
        img_s = np.zeros((b, s, cfg.image_size, cfg.image_size, 3),
                         np.float32)
        target_s = np.zeros((b, s, k, hs, hs), np.float32)
        weight_s = np.zeros((b, s, k), np.float32)
        img_q = np.zeros((b, cfg.image_size, cfg.image_size, 3), np.float32)
        target_q = np.zeros((b, k, hs, hs), np.float32)
        weight_q = np.zeros((b, k), np.float32)
        joints_q = np.zeros((b, k, 2), np.float32)
        joints_s = np.zeros((b, s, k, 2), np.float32)
        vis_s = np.zeros((b, s, k), np.float32)
        adj = np.zeros((b, k, k), np.float32)
        rand_mask = np.ones((b, k), np.float32)
        centers = np.zeros((b, 2), np.float32)
        scales = np.zeros((b, 2), np.float32)
        paths, bbox_ids, cats = [], [], []

        per_sample = isinstance(rng, (list, tuple))
        for bi, idx in enumerate(indices):
            # rng may be one Generator for the whole batch (legacy) or a
            # per-sample list — the latter makes any row slice of the
            # batch bit-identical to the full collate (sharded loading)
            ep_rng = rng[bi] if per_sample else rng
            supports, query, skeleton, pair = self.get_episode(
                idx, augment=augment, rng=ep_rng)
            for si, sup in enumerate(supports):
                img_s[bi, si] = sup.img
                target_s[bi, si] = sup.target
                weight_s[bi, si] = sup.target_weight
                joints_s[bi, si] = sup.joints
                vis_s[bi, si] = sup.joints_visible
            img_q[bi] = query.img
            target_q[bi] = query.target
            weight_q[bi] = query.target_weight
            joints_q[bi] = query.joints
            adj[bi] = graph.adjacency_from_edges(skeleton, k)
            if masking_ratio > 0:
                joint_w = weight_s[bi].prod(axis=0)
                rand_mask[bi] = self._rand_mask(
                    joint_w, masking_ratio,
                    rng=ep_rng if per_sample else None)
            qrec = self.db[pair[-1]]
            centers[bi] = query.center
            scales[bi] = query.scale
            paths.append(qrec["image_file"])
            bbox_ids.append(int(idx))
            cats.append(qrec["category_id"])

        meta = {"query_center": centers, "query_scale": scales,
                "query_image_file": paths, "bbox_id": bbox_ids,
                "category_id": cats,
                "pair": [self.paired_samples[i] for i in indices]}
        return EpisodeBatch(img_s=img_s, target_s=target_s,
                            weight_s=weight_s, img_q=img_q,
                            target_q=target_q, weight_q=weight_q,
                            joints_q=joints_q, binary_adj=adj,
                            rand_mask=rand_mask, joints_s=joints_s,
                            vis_s=vis_s, meta=meta)

    def batches(self, batch_size: int, *, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None,
                masking_ratio: float = 0.0, drop_last: bool = False):
        order = np.arange(len(self))
        if shuffle and rng is not None:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                return
            yield self.collate(list(chunk), rng=rng,
                               masking_ratio=masking_ratio)
