"""Result visualization; counterpart of edgecape_tpu/utils/visualization.py.

plot_results: a 3-panel figure — support image with its GT skeleton,
support image with the *learned* adjacency (edge width proportional to the
predicted weight), query image with predicted keypoints — rainbow keypoint
colors, auto-numbered output files. plot_attn and plot_similarity_maps are
the debug renders of the decoder's cross-attention and of the proposal
generator's similarity maps. matplotlib is imported by each function, with
the Agg backend, so the module imports where matplotlib is absent.
Inputs are numpy arrays on the host.
"""

from __future__ import annotations

import os

import numpy as np


def _colors(n):
    import matplotlib.cm as cm
    return [cm.rainbow(i / max(n - 1, 1)) for i in range(n)]


def _draw_panel(ax, img, kpts, vis, edges_w, colors, title):
    ax.imshow(np.clip(img, 0, 1) if img.dtype.kind == "f" else img)
    ax.set_title(title)
    ax.axis("off")
    for (i, j), w in edges_w:
        if vis[i] > 0 and vis[j] > 0 and w > 1e-3:
            ax.plot([kpts[i, 0], kpts[j, 0]], [kpts[i, 1], kpts[j, 1]],
                    color=colors[i], linewidth=float(4.0 * w), alpha=0.8)
    for i, (x, y) in enumerate(kpts[:, :2]):
        if vis[i] > 0:
            ax.scatter(x, y, s=40, color=colors[i], edgecolors="k",
                       linewidths=0.5, zorder=3)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    from ..ops.warp import IMAGENET_MEAN, IMAGENET_STD
    return np.clip(img * IMAGENET_STD + IMAGENET_MEAN, 0, 1)


def plot_results(support_img, query_img, support_kpts, support_vis,
                 pred_kpts, gt_edges, learned_adj, out_dir,
                 prefix: str = "result", normalize_imgs: bool = True):
    """Render the 3-panel figure; returns the written file path.

    Args:
      support_img/query_img: [H, W, 3] (normalized floats or uint8).
      support_kpts: [K, 2] pixel coords on the support image.
      support_vis: [K] visibility.
      pred_kpts: [K, 2] pixel coords on the query image.
      gt_edges: list of [i, j] GT skeleton edges.
      learned_adj: [K, K] learned edge weights (or None).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if normalize_imgs:
        support_img = denormalize_image(support_img)
        query_img = denormalize_image(query_img)
    k = support_kpts.shape[0]
    colors = _colors(k)
    n_panels = 3 if learned_adj is not None else 2
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 5))

    gt_e = [((int(i), int(j)), 1.0) for i, j in gt_edges]
    _draw_panel(axes[0], support_img, support_kpts, support_vis, gt_e,
                colors, "support + GT skeleton")
    if learned_adj is not None:
        adj = np.asarray(learned_adj)
        m = adj.max() + 1e-8
        learned_e = [((i, j), float(adj[i, j] / m))
                     for i in range(k) for j in range(i + 1, k)]
        _draw_panel(axes[1], support_img, support_kpts, support_vis,
                    learned_e, colors, "support + learned edge weights")
    _draw_panel(axes[-1], query_img, pred_kpts, support_vis, gt_e, colors,
                "query + prediction")

    os.makedirs(out_dir, exist_ok=True)
    idx = 0
    while os.path.exists(os.path.join(out_dir, f"{prefix}_{idx}.png")):
        idx += 1
    path = os.path.join(out_dir, f"{prefix}_{idx}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_attn(query_img, attn_maps, kpt_indices, out_dir,
              gt_adj=None, learned_adj=None, prefix: str = "attn",
              normalize_imgs: bool = True):
    """Debug render of decoder cross-attention (reference plot_attn,
    models/utils/visualization.py:113-236 / return_attn_map,
    encoder_decoder.py:391-392).

    attn_maps: [L, K, h*w] per-layer head-averaged kp->image attention
    probabilities. Renders one row per selected keypoint with its per-layer
    attention over the query image, plus (optionally) the GT and learned
    adjacency matrices as a final row — the reference figure's content in
    a compact grid. Returns the written file path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if normalize_imgs:
        query_img = denormalize_image(query_img)
    attn = np.asarray(attn_maps, np.float32)
    n_layers, k, hw = attn.shape
    g = int(round(hw ** 0.5))
    hq, wq = query_img.shape[:2]
    n_kp = len(kpt_indices)
    n_mats = int(gt_adj is not None) + int(learned_adj is not None)
    n_rows = n_kp + (1 if n_mats else 0)
    # enough columns for the adjacency row even with a 1-layer decoder
    n_cols = max(n_layers, n_mats, 1)
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(4 * n_cols, 4 * n_rows),
                             squeeze=False)
    for r, ki in enumerate(kpt_indices):
        for l in range(n_cols):
            ax = axes[r, l]
            if l >= n_layers:
                ax.axis("off")
                continue
            ax.imshow(np.clip(query_img, 0, 1))
            amap = attn[l, ki].reshape(g, g)
            ax.imshow(amap, alpha=0.6, extent=(0, wq, hq, 0), cmap="Reds")
            ax.set_title(f"kp {ki} / decoder layer {l}")
            ax.axis("off")
    if n_rows > n_kp:
        mats = [(t, m) for t, m in (("GT adjacency", gt_adj),
                                    ("learned adjacency", learned_adj))
                if m is not None]
        for l in range(n_cols):
            ax = axes[n_kp, l]
            if l >= len(mats):
                ax.axis("off")
                continue
            title, mat = mats[l]
            ax.imshow(np.asarray(mat, np.float32), cmap="Reds")
            ax.set_title(title)
    os.makedirs(out_dir, exist_ok=True)
    idx = 0
    while os.path.exists(os.path.join(out_dir, f"{prefix}_{idx}.png")):
        idx += 1
    path = os.path.join(out_dir, f"{prefix}_{idx}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_similarity_maps(query_img, similarity, kpt_indices, out_dir,
                         prefix: str = "similarity",
                         normalize_imgs: bool = True):
    """Debug render of per-keypoint similarity maps over the query image
    (reference visualization.py plot_heatmap equivalent).

    query_img: [H, W, 3]; similarity: [K, h, w] proposal-generator logits.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if normalize_imgs:
        query_img = denormalize_image(query_img)
    n = len(kpt_indices)
    fig, axes = plt.subplots(1, max(n, 1), figsize=(4 * max(n, 1), 4))
    if n == 1:
        axes = [axes]
    hq, wq = query_img.shape[:2]
    for ax, ki in zip(axes, kpt_indices):
        ax.imshow(np.clip(query_img, 0, 1))
        sim = np.asarray(similarity[ki], dtype=np.float32)
        e = np.exp(sim - sim.max())
        prob = e / e.sum()
        ax.imshow(prob, alpha=0.6, extent=(0, wq, hq, 0), cmap="jet")
        ax.set_title(f"kp {ki}")
        ax.axis("off")
    os.makedirs(out_dir, exist_ok=True)
    idx = 0
    while os.path.exists(os.path.join(out_dir, f"{prefix}_{idx}.png")):
        idx += 1
    path = os.path.join(out_dir, f"{prefix}_{idx}.png")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
