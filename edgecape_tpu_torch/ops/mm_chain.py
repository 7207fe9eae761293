"""A chain of `reps` residual matmul pairs, the pure-matmul core of the
fused blocks' MLP half, as one hand-written CUDA launch.

Replaces the TPU kernel of `scripts/probe_m_fold.py` (`run`, body
`make_kernel` / `_mm_chain`): for every row of x [b, n, c], `reps` times

    h = bf16(x @ w1);  y = h @ w2 (fp32);  x = bf16(f32(x) + y)

with bf16 operands and fp32 accumulation. The TPU kernel holds a group of
`group` images and both weights in VMEM and asks whether one tall product
over the folded [group * n, c] rows (`fold`) beats `group` products over
[n, c] (`loop`). On the H100 the op is bound by operations
(4 * b * n * c * f * reps against x in and out and the weights once), and
what `fold` changes is where the 64-row tiles are cut: inside each image's
n rows (n = 264 leaves a tile with 8 valid rows of 64), or from the group's
flat group * n rows. One thread block keeps its row tile in shared memory
for the whole chain and streams the weights in 64-wide chunks of f, so h
never reaches device memory (`csrc/mm_chain.cu`). Both cuts give the same
bits: a row's accumulation order does not depend on its place in a tile.

The wrapper launches the kernel for a CUDA tensor and takes the plain
PyTorch version for a CPU tensor; `launches` counts kernel runs.
"""

from __future__ import annotations

import torch

launches = 0


def _chain(x: torch.Tensor, w1f: torch.Tensor, w2f: torch.Tensor,
           reps: int) -> torch.Tensor:
    """The chain on rows x [m, c] bf16 with fp32 copies of the weights."""
    for _ in range(reps):
        h = (x.to(torch.float32) @ w1f).to(torch.bfloat16)
        y = h.to(torch.float32) @ w2f
        x = (x.to(torch.float32) + y).to(torch.bfloat16)
    return x


def _check(x, w1, w2, group):
    if x.dim() != 3:
        raise ValueError(f"mm_chain takes x [b, n, c], got {tuple(x.shape)}")
    b, n, c = x.shape
    if w1.dim() != 2 or w1.shape[0] != c \
            or tuple(w2.shape) != (w1.shape[1], c):
        raise ValueError(f"mm_chain weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not fit c={c}")
    if group <= 0 or b % group:
        raise ValueError(f"batch {b} is not a multiple of group {group}")
    return b, n, c


def mm_chain_plain(x, w1, w2, reps: int, group: int,
                   fold: bool) -> torch.Tensor:
    """Plain PyTorch version: fp32 matmuls on the bf16-rounded operands,
    with the TPU kernel's rounding points. `fold` multiplies each group's
    [group * n, c] rows at once, else every image's [n, c] rows."""
    b, n, c = _check(x, w1, w2, group)
    bf = torch.bfloat16
    w1f = w1.to(bf).to(torch.float32)
    w2f = w2.to(bf).to(torch.float32)
    rows = x.to(bf).reshape(b // group, group * n, c) if fold else x.to(bf)
    out = torch.stack([_chain(r, w1f, w2f, reps) for r in rows])
    return out.reshape(b, n, c)


def mm_chain(x, w1, w2, reps: int, group: int, fold: bool) -> torch.Tensor:
    """`reps` steps of x = bf16(f32(x) + bf16(x @ w1) @ w2) on x [b, n, c]
    bf16, w1 [c, f], w2 [f, c] bf16; returns bf16 [b, n, c]. Row tiles are
    cut from each group's group * n rows (`fold`) or each image's n rows."""
    global launches
    if not x.is_cuda:
        return mm_chain_plain(x, w1, w2, reps, group, fold)
    from . import kernels as K
    b, n, _ = _check(x, w1, w2, group)
    segs, seg_rows = (b // group, group * n) if fold else (b, n)
    out = K.mm_chain(x.contiguous(), w1.contiguous(), w2.contiguous(), reps,
                     segs, seg_rows)
    launches += 1
    return out
