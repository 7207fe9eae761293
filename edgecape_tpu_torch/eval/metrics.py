"""Keypoint metrics: PCK@thr, mPCK, NME, AUC, EPE.

Definitions match mmpose.core.evaluation.top_down_eval (the reference's
metric source, used at test_base_dataset.py:119-155): distances are
normalized per-axis by the threshold box, invalid joints carry distance -1,
PCK averages per-joint accuracy over joints with any valid sample.
"""

from __future__ import annotations

import numpy as np


def _normalized_distances(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
                          normalize: np.ndarray) -> np.ndarray:
    """pred/gt [N, K, 2], mask [N, K] bool, normalize [N, 2] -> [K, N]
    distances with -1 for invalid entries (mmpose _calc_distances)."""
    n, k, _ = pred.shape
    dists = np.full((n, k), -1.0, dtype=np.float32)
    valid = mask & (normalize > 0).all(axis=-1)[:, None]
    norm = np.where(normalize <= 0, 1e6, normalize)
    d = np.linalg.norm((pred - gt) / norm[:, None, :], axis=-1)
    dists[valid] = d[valid]
    return dists.T


def pck_accuracy(pred, gt, mask, thr, normalize):
    """Returns (per-joint acc [K], avg_acc, num_valid_joints) — the
    keypoint_pck_accuracy contract."""
    dists = _normalized_distances(pred, gt, mask, normalize)
    acc = np.array([
        (dists[k][dists[k] != -1] < thr).mean() if (dists[k] != -1).any()
        else -1.0
        for k in range(dists.shape[0])])
    valid = acc != -1
    avg = float(acc[valid].mean()) if valid.any() else 0.0
    return acc, avg, int(valid.sum())


def nme(pred, gt, mask, normalize_factor):
    dists = _normalized_distances(pred, gt, mask, normalize_factor)
    d = dists[dists != -1]
    return float(d.mean()) if d.size else 0.0


def auc(pred, gt, mask, normalize, num_step: int = 20):
    norm = np.full((pred.shape[0], 2), normalize, dtype=np.float32)
    ys = []
    for i in range(num_step):
        thr = 1.0 * i / num_step
        _, avg, _ = pck_accuracy(pred, gt, mask, thr, norm)
        ys.append(avg)
    return float(np.mean(ys))


def epe(pred, gt, mask):
    norm = np.ones((pred.shape[0], 2), dtype=np.float32)
    dists = _normalized_distances(pred, gt, mask, norm)
    d = dists[dists != -1]
    return float(d.mean()) if d.size else 0.0
