"""Skeleton-graph adjacency utilities; counterpart of
edgecape_tpu/ops/graph.py (device functions in torch, the host edge-list
rasteriser as a numpy twin)."""

from __future__ import annotations

import numpy as np
import torch


def adjacency_from_edges(edges, num_pts: int) -> np.ndarray:
    """Host-side: edge list [[i, j], ...] -> symmetric binary [K, K]."""
    adj = np.zeros((num_pts, num_pts), dtype=np.float32)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2) if len(edges) \
        else np.zeros((0, 2), dtype=np.int64)
    for i, j in edges:
        if 0 <= i < num_pts and 0 <= j < num_pts:
            adj[i, j] = 1.0
            adj[j, i] = 1.0
    return adj


def _eye_valid(valid: torch.Tensor, k: int, dtype) -> torch.Tensor:
    eye = torch.eye(k, dtype=dtype, device=valid.device)
    return eye * valid[..., None, :]


def normalize_adjacency(binary_adj: torch.Tensor,
                        kp_invalid: torch.Tensor) -> torch.Tensor:
    """[..., K, K] binary adjacency -> [..., 2, K, K]: diag(valid) and the
    masked row-normalised adjacency (zero rows stay zero)."""
    valid = (~kp_invalid).to(binary_adj.dtype)
    adj = binary_adj * valid[..., :, None] * valid[..., None, :]
    row_sum = adj.sum(dim=-1, keepdim=True)
    pos = row_sum > 0
    adj = torch.where(pos, adj / torch.where(pos, row_sum,
                                             torch.ones_like(row_sum)),
                      torch.zeros_like(adj))
    diag = _eye_valid(valid, binary_adj.shape[-1], binary_adj.dtype)
    return torch.stack([diag, adj], dim=-3)


def soft_normalize_adjacency(adj: torch.Tensor, kp_invalid: torch.Tensor, *,
                             normalize: bool = True,
                             stack_diag: bool = True) -> torch.Tensor:
    """Mask, divide by row-sum + 1e-8, optionally stack with diag(valid)."""
    valid = (~kp_invalid).to(adj.dtype)
    adj = adj * valid[..., :, None] * valid[..., None, :]
    if normalize:
        adj = adj / (adj.sum(dim=-1, keepdim=True) + 1e-8)
    if not stack_diag:
        return adj
    diag = _eye_valid(valid, adj.shape[-1], adj.dtype)
    return torch.stack([diag, adj], dim=-3)


def markov_hop_stack(adj: torch.Tensor, max_hop: int) -> torch.Tensor:
    """Row-stochastic transition powers 0..max_hop, fp32, channels-last
    [..., K, K, max_hop+1]."""
    adj = adj.to(torch.float32)
    adj = adj / (adj.sum(dim=-1, keepdim=True) + 1e-8)
    k = adj.shape[-1]
    powers = [torch.eye(k, dtype=torch.float32,
                        device=adj.device).expand(adj.shape)]
    for _ in range(max_hop):
        powers.append(torch.matmul(powers[-1], adj))
    return torch.stack(powers, dim=-1)
