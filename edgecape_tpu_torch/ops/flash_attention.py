"""Fused multi-head attention with a key mask, as a hand-written CUDA
kernel (ops/kernels.attention).

Replaces the TPU kernel `edgecape_tpu/ops/flash_attention.py:flash_mha`
(`_attn_kernel`, `_kernel_with_bias`): softmax(q k^T / sqrt(D) + key
mask) v with bf16 operands (fp32 callers are rounded at the load), fp32
softmax, probabilities rounded to bf16 before P.V, the output rounded to
bf16 and returned in the caller's dtype.

On the H100 the eval path calls it on the skeleton refine layers'
keypoint self-attention ([34 x 8 heads, 100 x 100, D=32]), and the same
kernel (`attn_kernel` in csrc/kernels.cu) is the attention step of every
fused op of the eval path. At these shapes the operands are a few
microseconds of memory traffic and less of tensor-core time, so what the
kernel spends is latency and issue slots; the design (see the note in
csrc/kernels.cu) keeps every score in registers: mma.sync tiles whose
accumulators become the operand of P.V by a pack, a warp per 16-row query
tile, the key row in one pass where it fits in registers (up to 128 keys)
and in two register passes over 32-key chunks above, query tiles split
over blocks by `ops/kernels.attention_plan`, keys and values copied in by
cp.async, and the bool key mask read by the kernel. Above 512 keys (at
head dim 128 above 416), which a block's shared memory does not hold,
attn_long_kernel (csrc/attn_long.cu) streams the keys in tiles through
one pass with the online softmax; the training pair has streaming forms
as well (one pass each, the backward's delta formed from the forward's
fp32 output, which the autograd Function keeps for them). q/k/v are read
straight from the [B, N, H*D] projections (no head transpose or cast
pass), and a call is one launch.

The wrapper runs the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; `launches` counts kernel runs.

`flash_mha_train` is the differentiable attention of the training step
and replaces the TPU pair `_flash_train_fwd` / `_flash_train_bwd` of the
same JAX file: softmax(q k^T / sqrt(D) + key mask + bias) with dropout on
the probabilities, times v, with bf16 matmul operands and fp32 softmax,
dropout, output and gradients (dq, dk, dv and dbias for the Markov bias).
CUDA kernels (ops/kernels.attention_train_fwd / _bwd) behind a
`torch.autograd.Function`: the forward (`train_fwd_kernel`, the same
register-resident design with p kept fp32 through the dropout) keeps each
row's max and reciprocal exp-sum, the backward recomputes the
probabilities from them and regenerates the dropout mask from the same
Philox seed, so neither scores, probabilities nor mask reach device
memory. The backward is register-resident too: a query-major kernel
(`train_bwd_q_kernel`: delta, dbias, dq) and a key-major one
(`train_bwd_k_kernel`: dk, dv on transposed score tiles), both with the
sequence split over the grid by `ops/kernels.attention_bwd_plan`, the bool
key mask read in the kernels, no atomics and sums in a fixed order. At the
training shapes ([16 x 8 heads, 100..356 tokens, D=32]) the device time is
a few hundredths of a millisecond and the host's launch work dominates
the op. `launches_fwd` / `launches_bwd` count the forward's and the
backward's runs.
"""

from __future__ import annotations

import math

import torch

from . import plain

launches = 0
launches_fwd = 0
launches_bwd = 0


def flash_mha_plain(q, k, v, key_valid=None):
    """Plain PyTorch version. q [B, Nq, H, D]; k/v [B, Nk, H, D];
    key_valid [B, Nk] bool or None. Returns [B, Nq, H, D] in q.dtype."""
    b, nq, h, d = q.shape
    nk = k.shape[1]
    kb = None if key_valid is None else plain.key_bias(key_valid)
    out = plain.attention(q.reshape(b, nq, h * d), k.reshape(b, nk, h * d),
                          v.reshape(b, nk, h * d), num_heads=h,
                          scale=1.0 / math.sqrt(d), kb=kb)
    return out.reshape(b, nq, h, d).to(q.dtype)


def flash_mha(q, k, v, key_valid=None):
    """softmax(q k^T / sqrt(D) + key mask) v, as the TPU kernel computes
    it (see the module docstring)."""
    global launches
    if not q.is_cuda:
        return flash_mha_plain(q, k, v, key_valid)
    from . import kernels as K
    b, nq, h, d = q.shape
    nk = k.shape[1]
    out = K.attention(q.reshape(b, nq, h * d), k.reshape(b, nk, h * d),
                      v.reshape(b, nk, h * d), num_heads=h,
                      scale=1.0 / math.sqrt(d), key_valid=key_valid,
                      out_dtype=q.dtype)
    launches += 1
    return out.reshape(b, nq, h, d)


class _RoundGradBf16(torch.autograd.Function):
    """Identity whose gradient is rounded to bf16 (kept in fp32): the
    backward kernel's rounding of `do` and `ds` as matmul operands."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return plain.bf16(g)


def _bf16_operand(x):
    """bf16-rounded values in fp32, with the gradient passed through
    unrounded (the kernels store every gradient in fp32)."""
    x = x.to(torch.float32)
    return x + (plain.bf16(x) - x).detach()


def flash_mha_train_plain(q, k, v, key_valid=None, bias=None, *,
                          dropout_rate: float = 0.0, generator=None,
                          keep=None, scale=None):
    """Plain PyTorch version of flash_mha_train with the kernels' rounding
    points, differentiated by autograd. `keep` is an explicit dropout
    mask, bool [B, H, Nq, Nk]; without one and with dropout_rate > 0 it
    is drawn from `generator`. A row whose keys are all masked gives 0,
    like the kernels. `scale`: 1 / sqrt(D) by default (a caller whose
    heads are padded, ops/kernels.py pad_heads, gives the true one)."""
    b, nq, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qf, kf, vf = (_bf16_operand(t).transpose(1, 2) for t in (q, k, v))
    s = _RoundGradBf16.apply(
        torch.matmul(qf, kf.transpose(-1, -2)) * scale)
    if key_valid is not None:
        s = s + plain.key_bias(key_valid)[:, None, None, :]
    if bias is not None:
        s = s + bias.to(torch.float32)
    m = s.detach().amax(dim=-1, keepdim=True)
    e = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    total = e.sum(dim=-1, keepdim=True)
    p = e / torch.where(total > 0, total, torch.ones_like(total))
    if dropout_rate > 0.0:
        if keep is None:
            if generator is None:
                raise ValueError("dropout needs a generator")
            keep = torch.rand(p.shape, generator=generator,
                              device=generator.device) >= dropout_rate
        p = torch.where(keep.to(p.device), p * (1.0 / (1.0 - dropout_rate)),
                        torch.zeros_like(p))
    out = _RoundGradBf16.apply(torch.matmul(_bf16_operand(p), vf))
    return out.transpose(1, 2).to(q.dtype)


def _flat(t):
    """[B, N, H, D] -> [B, N, H*D] with a unit last stride."""
    b, n, h, d = t.shape
    return t.reshape(b, n, h * d)


class _FlashTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, bias, rate, seed):
        global launches_fwd
        from . import kernels as K
        b, nq, h, d = q.shape
        out, stats = K.attention_train_fwd(
            _flat(q), _flat(k), _flat(v), num_heads=h,
            scale=1.0 / math.sqrt(d), key_valid=key_valid, bias=bias,
            seed=seed, rate=rate)
        launches_fwd += 1
        # the streaming backward forms delta from the fp32 output
        streams = K.attention_bwd_plan(nq, k.shape[1], d).get("long")
        ctx.save_for_backward(q, k, v, key_valid, bias, stats, seed,
                              out if streams else None)
        ctx.rate = rate
        return out.reshape(b, nq, h, d).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        global launches_bwd
        from . import kernels as K
        q, k, v, key_valid, bias, stats, seed, out = ctx.saved_tensors
        b, nq, h, d = q.shape
        dq, dk, dv, dbias = K.attention_train_bwd(
            _flat(q), _flat(k), _flat(v), _flat(g), stats, num_heads=h,
            scale=1.0 / math.sqrt(d), key_valid=key_valid, bias=bias,
            seed=seed, rate=ctx.rate,
            need_dbias=ctx.needs_input_grad[4], out=out)
        launches_bwd += 1
        return (dq.reshape(q.shape).to(q.dtype),
                dk.reshape(k.shape).to(k.dtype),
                dv.reshape(v.shape).to(v.dtype), None,
                None if dbias is None else dbias.to(bias.dtype), None, None)


def dropout_seed(generator, device) -> torch.Tensor:
    """A seed for the kernels' Philox stream, drawn from `generator`: a
    one-element int64 tensor on `device` (the kernels read it there, so
    nothing waits for the device)."""
    return torch.randint(0, 2 ** 62, (1,), generator=generator,
                         device=generator.device).to(device)


def flash_mha_train(q, k, v, key_valid=None, bias=None, *,
                    dropout_rate: float = 0.0, generator=None):
    """Differentiable attention for the training step. q [B, Nq, H, D];
    k/v [B, Nk, H, D]; key_valid [B, Nk] bool or None; bias additive
    logits [B, H, Nq, Nk] or None (receives a gradient). dropout_rate
    drops probabilities inside the kernel, seeded from `generator`
    (required when the rate is > 0); the backward regenerates the same
    mask. CUDA tensors go to the kernels (head dims 1-128, run at 32, 64
    or 128; above what a resident block holds, 512 tokens or at head dim
    128 about 400, the streaming ones; above 128 an error), CPU tensors to
    the plain version. No model path of the port trains a head dim above
    64 here: the model trains rows above 512 tokens on its fp32 plain path,
    as the JAX module does, so the streaming training kernels run on
    direct calls."""
    if dropout_rate > 0.0 and generator is None:
        raise ValueError("dropout needs a generator")
    if not q.is_cuda:
        return flash_mha_train_plain(q, k, v, key_valid, bias,
                                     dropout_rate=dropout_rate,
                                     generator=generator)
    seed = dropout_seed(generator, q.device) if dropout_rate > 0.0 else None
    return _FlashTrain.apply(q, k, v, key_valid, bias, float(dropout_rate),
                             seed)
