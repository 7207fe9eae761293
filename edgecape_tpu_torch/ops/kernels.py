"""Build, load and call the hand-written CUDA kernels (`csrc/*.cu`):
in `kernels.cu` the building blocks of the eval ops, the ViT attention
and MLP halves,
the decoder stack's own kernels and the training attention's forward /
backward pair, in `attn_long.cu` the same attention kernels with the keys
streamed, for rows longer than a block holds, in `head_wide.cu` the
head's post-attention kernels, keypoint head and bias attention at every
width other than 256 channels in 8 heads of 32 (the decoder's in
`dec_self_wide.cu`, `dec_wide.cu` and `kpt_wide.cu`), in `bias_long.cu`
the bias attention above 128 keypoints, in `vit_wide.cu` the
LayerNorm + projection of the ViT block at every trunk width other than
384 channels in 6 heads, in `mm_chain.cu` the matmul chain of the probe
tool.

Each source is compiled with `nvcc` for `sm_90a` into a shared library
with a plain C interface at first use (one compiler process per source,
all started together), and loaded with ctypes. The build lands in
`edgecape_tpu_torch/_build/` (or `$EDGECAPE_TORCH_BUILD_DIR`), named by a
hash of the source and flags, so an unchanged tree reuses it and an
edited source rebuilds. Nothing here runs at import time: the CPU
tests import every module of the package.

The Python helpers below take torch tensors, check what the kernels
accept (device, dtype, strides) and launch on
`torch.cuda.current_stream()`. Every C entry point returns
`cudaGetLastError()`; a non-zero code raises.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC"]

F32, BF16 = 0, 1
ACT_NONE, ACT_GELU, ACT_RELU = 0, 1, 2

_LIB = None                               # the loaded libraries
build_seconds: Optional[float] = None     # wall time of the last build
build_logs: dict = {}                     # nvcc's output by source, this process
# Launches of every kernel of kernels.cu, by the kernel's name as a profiler
# trace shows it (a substring of it), each counted where its wrapper
# launches it; mm_chain_kernel's count is ops/mm_chain.py `launches`.
launches = dict.fromkeys((
    "gemm_tma_kernel", "gemm_kernel", "layernorm_kernel", "add_pos_kernel",
    "attn_kernel", "sine_feats_kernel", "train_fwd_kernel",
    "train_bwd_q_kernel", "train_bwd_k_kernel", "dropout_mask_kernel",
    "enc_post_kernel", "dec_post_self_kernel", "dec_post_cross_kernel",
    "vit_mlp_kernel", "vit_qkv_kernel", "vit_attn_kernel",
    "bias_attn_kernel", "kpt_head_kernel", "attn_long_kernel",
    "train_fwd_long_kernel", "train_bwd_q_long_kernel",
    "train_bwd_k_long_kernel", "attn_long_kernel<128>",
    "train_fwd_long_kernel<128>", "train_bwd_q_long_kernel<128>",
    "train_bwd_k_long_kernel<128>", "enc_post_wide_kernel",
    "dec_post_self_wide_kernel", "dec_post_cross_wide_kernel",
    "dec_post_gcn_wide_kernel", "kpt_head_wide_kernel", "bias_attn_wide_kernel",
    "bias_attn_long_kernel", "vit_ln_gemm_kernel", "kpt_coord_kernel"),
    0)

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_F = ctypes.c_float
_U32 = ctypes.c_uint
# q, k, v, dtype, six strides, B, H, D, Nq, Nk, bool key mask + stride,
# bias, scale, seed (device pointer), keep threshold, 1 / (1 - rate)
_TRAIN_HEAD = [_P, _P, _P, _I, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _I,
               _P, _L, _P, _F, _P, _U32, _F]
# the launch plan of the attention forward kernels (attention_plan): query
# split, warps, key tiles per chunk, shared-memory bytes
_PLAN = [_I, _I, _I, _L]
# the backward's plan (attention_bwd_plan): the query-major kernel's split,
# warps, key tiles per chunk and shared memory, then the key-major one's
# split, warps and shared memory
_BWD_PLAN = [_I, _I, _I, _L, _I, _I, _L]
# the streaming kernels' plans: split, warps, shared memory (the backward's
# for its query-major kernel, then its key-major one)
_LONG_PLAN = [_I, _I, _L]
_SIGNATURES = {
    "ec_gemm": [_P, _L, _L, _P, _L, _L, _I, _P, _L, _L, _I, _I, _I, _I, _I,
                _P, _P, _I, _L, _L, _I, _P, _I, _L, _L, _P, _I, _P],
    "ec_layernorm": [_P, _I, _L, _P, _I, _L, _P, _P, _F, _P, _L, _P, _L,
                     _I, _I, _P],
    "ec_add_pos": [_P, _I, _P, _P, _L, _L, _P],
    "ec_attention": [_P, _P, _P, _I, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I,
                     _I, _P, _L, _P, _F, _P, _I, _L, _L] + _PLAN + [_P],
    "ec_sine_feats": [_P, _P, _P, _L, _I, _P],
    # qkv, B, N, key mask + stride, hops, n_hop, hidden, the MLP's four
    # tensors, scale, out, then the plan: query split, tiles a block, smem
    "ec_bias_attention": [_P, _I, _I, _P, _L, _P, _I, _I, _P, _P, _P, _P, _F,
                          _P, _I, _I, _L, _P],
    "ec_kpt_head": [_P] * 14 + [_I, _F, _F, _P],
    "ec_attn_train_fwd": _TRAIN_HEAD + [_P, _L, _L, _P] + _PLAN + [_P],
    "ec_attn_train_bwd": _TRAIN_HEAD + [_P, _I, _L, _L, _P, _P, _P, _P, _P,
                                        _P] + _BWD_PLAN + [_P],
    "ec_attention_long": [_P, _P, _P, _I, _L, _L, _L, _L, _L, _L, _I, _I, _I,
                          _I, _I, _P, _L, _P, _F, _P, _I, _L, _L] + _LONG_PLAN
    + [_P],
    "ec_attn_train_fwd_long": _TRAIN_HEAD + [_P, _L, _L, _P] + _LONG_PLAN
    + [_P],
    # ... dout, its dtype and strides, stats, the forward's fp32 output and
    # its strides, dq, dk, dv, dbias, delta, the two kernels' plans
    "ec_attn_train_bwd_long": _TRAIN_HEAD + [_P, _I, _L, _L, _P, _P, _L, _L,
                                             _P, _P, _P, _P, _P]
    + 2 * _LONG_PLAN + [_P],
    "ec_dropout_mask": [_P, _U32, _L, _I, _I, _P, _P],
    "ec_mm_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ec_enc_post": [_P] * 13 + [_I, _P, _I, _P, _I, _I, _F, _P],
    "ec_dec_post_self": [_P] * 12 + [_I, _F, _P],
    "ec_dec_post_cross": [_P] * 11 + [_I] + [_P] * 5 + [_I, _I, _I, _I, _F,
                                                         _P],
    # x, its dtype, g, be, w1, b1, w2, b2, ls, K-major weights, out, its
    # dtype, the next norm's g, be and output, R, F, eps
    "ec_vit_mlp": [_P, _I] + [_P] * 7 + [_I, _P, _I, _P, _P, _P, _I, _I, _F,
                                          _P],
    # x, its dtype, LN1's g and be, Wqkv, its bias, qkv, R, eps
    "ec_vit_qkv": [_P, _I, _P, _P, _P, _P, _P, _I, _F, _P],
    # qkv, x, its dtype, Wproj, bp, ls, out, its dtype, B, N, scale, smem
    "ec_vit_attn": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _L, _P],
    # head_wide.cu: the operands, then R, C, the padded widths, eps
    "ec_enc_post_wide": [_P] * 13 + [_I, _P, _I, _P, _L, _I, _I, _I, _F, _P],
    "ec_dec_post_self_wide": [_P] * 12 + [_L, _I, _I, _I, _F, _P],
    "ec_dec_post_cross_wide": [_P] * 11 + [_I] + [_P] * 7 + [_I] * 7
    + [_F, _P],
    # kpt_wide.cu: the operands, R, C, c_pad, eps, ieps
    "ec_kpt_head_wide": [_P] * 14 + [_L, _I, _I, _F, _F, _P],
    # qkv, B, N, H, D, key mask + stride, hops, n_hop, hidden, the MLP's
    # four tensors, scale, out, then the plan: query split, tiles a block,
    # heads a pass, resident, smem
    "ec_bias_attention_wide": [_P, _I, _I, _I, _I, _P, _L, _P, _I, _I, _P,
                               _P, _P, _P, _F, _P, _I, _I, _I, _I, _L, _P],
    # bias_long.cu: qkv, B, N, H, D, key mask + stride, hops, n_hop,
    # hidden, the MLP's four tensors, scale, out, the scores' scratch, then
    # the plan: blocks, keys a tile, smem
    "ec_bias_attention_long": [_P, _I, _I, _I, _I, _P, _L, _P, _I, _I, _P,
                               _P, _P, _P, _F, _P, _P, _I, _I, _L, _P],
    # vit_wide.cu: x, its dtype, round_in, g, be, W, kmajor, bias, act,
    # the scratch h, out, R, C, N, eps, smem, column parts
    "ec_vit_ln_gemm": [_P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I,
                       _I, _F, _L, _I, _P],
    # the count out
    "ec_vit_ln_gemm_ctas": [_P],
    # dec_wide.cu: C, K, the six numbers out
    "ec_dec_wide_layout": [_I, _I, _P],
    # kpt_wide.cu: C, the five numbers out
    "ec_kpt_wide_layout": [_I, _P],
    # kpt_coord.cu: h, wo, bo, ct, pts, outs, R, C, ieps
    "ec_kpt_coord": [_P] * 6 + [_L, _I, _F, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set $NVCC or $CUDA_HOME, or put nvcc "
                       "on PATH); the CUDA kernels are built at first use")


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build_dir() -> str:
    return os.environ.get("EDGECAPE_TORCH_BUILD_DIR",
                          os.path.join(_PKG, "_build"))


def headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path(src: str) -> str:
    """The library of one source, named by a hash of it, the headers it
    may include and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + headers():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(),
                        f"libedgecape_{stem}_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> list:
    """Compile every source whose library is missing, one `nvcc` per
    source, all started together; returns the libraries' paths. ptxas's
    report (registers, spills) of each source built lands in build_logs
    and, with verbose, on stdout."""
    global build_seconds
    paths = [library_path(src) for src in sources()]
    todo = [(src, path) for src, path in zip(sources(), paths)
            if not os.path.exists(path)]
    if not todo:
        return paths
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, path in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        cmd = [nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-o", tmp, src]
        procs.append((src, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(out)
            continue
        build_logs[os.path.basename(src)] = out
        if verbose:
            print(out)
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def ptxas_usage(kernel: str) -> list:
    """[(entry function, registers, spill store bytes, spill load bytes)]
    of each instantiation of `kernel` in the ptxas reports of this
    process's build (empty when the libraries were built before it);
    `kernel<N>` (a launch counter's name, such as "attn_long_kernel<128>")
    picks that kernel's instance of template argument N alone."""
    base, _, arg = kernel.partition("<")
    if arg:     # the mangled name of that instance
        kernel = f"{len(base)}{base}ILi{arg.rstrip('>')}E"
    rows, name, spills = [], None, (0, 0)
    for log in build_logs.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                spills = (0, 0)
            elif name and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                spills = (int(m.group(1)), int(m.group(2)))
            elif name and (m := re.search(r"Used (\d+) registers", line)):
                if kernel in name:
                    rows.append((name, int(m.group(1))) + spills)
                name = None
    return rows


class _Libraries:
    """The loaded libraries, one per source; an entry point is looked up
    in each."""

    def __init__(self, libs):
        self._libs = libs

    def __getattr__(self, name):
        for so in self._libs:
            try:
                return getattr(so, name)
            except AttributeError:
                pass
        raise AttributeError(name)


def lib() -> _Libraries:
    global _LIB
    if _LIB is None:
        so = _Libraries([ctypes.CDLL(path) for path in build()])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(so, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        so.ec_error_string.argtypes = [ctypes.c_int]
        so.ec_error_string.restype = ctypes.c_char_p
        _LIB = so
    return _LIB


def _call(name: str, *args) -> None:
    so = lib()
    rc = getattr(so, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} "
                           f"({so.ec_error_string(rc).decode()})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _dt(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return F32
    if t.dtype == torch.bfloat16:
        return BF16
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _cuda(*ts) -> None:
    for t in ts:
        if t is not None and not t.is_cuda:
            raise ValueError("kernel operands must be CUDA tensors")


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Bias / LayerNorm / LayerScale vectors: contiguous fp32."""
    if t is None:
        return None
    return t.detach().to(torch.float32).contiguous()


# The GEMM's two mainloops (csrc/kernels.cu): tiles copied by the threads
# and multiplied by WMMA, which takes any operand, and TMA-fed wgmma, which
# needs operands a tensor map can describe; GEMM_TMA_SLABS is the latter
# summing each 64-deep k tile in a fresh accumulator (one block an SM),
# for the split route's products above WIDE_MAX_C channels (gemm's
# `slabs`; split_refusal).
GEMM_COPY, GEMM_TMA, GEMM_TMA_SLABS = 0, 1, 2
GEMM_TMA_MIN_N = 32


def tma_operand_ok(ptr: int, ld: int, batch_stride: int, batch: int) -> bool:
    """Can a tensor map describe a bf16 operand with this base address,
    row stride and batch stride (in elements)? Base, rows and batches must
    start on 16 bytes; a batch stride of 0 shares the operand."""
    return ptr % 16 == 0 and ld > 0 and ld % 8 == 0 \
        and (batch == 1 or (batch_stride >= 0 and batch_stride % 8 == 0))


def gemm_mainloop(n: int, batch: int, a, b) -> int:
    """The mainloop a GEMM with N output columns takes: GEMM_TMA when both
    operands, given as (address, row stride, batch stride), qualify for a
    tensor map and the output is at least GEMM_TMA_MIN_N wide (a narrower
    one would use a sliver of a 128-wide tile), else GEMM_COPY. The choice
    depends on the operands alone."""
    if n >= GEMM_TMA_MIN_N and tma_operand_ok(*a, batch) \
            and tma_operand_ok(*b, batch):
        return GEMM_TMA
    return GEMM_COPY


def gemm(a: torch.Tensor, b: torch.Tensor, *, b_nk: bool,
         out_dtype=torch.bfloat16, bias=None, pre=None, act: int = ACT_NONE,
         res=None, ls=None, out=None, mainloop=None,
         slabs: bool = False) -> torch.Tensor:
    """out = epilogue(a @ (b^T if b_nk else b)).

    a: [M, K] or batched [Z, M, K] bf16 with unit last stride. b: [N, K]
    (b_nk, a torch Linear weight) or [K, N], optionally batched [Z, ...]
    (an unbatched operand is shared across the batch). pre / res:
    [M, N] or [Z, M, N] fp32 or bf16 (a 2-D one is shared across the
    batch). Epilogue: y = acc + bias + pre; act; y = res + ls * y.
    `out`: a tensor of the result's shape to write into (its dtype is the
    output dtype), for callers that keep their activation buffers.
    `mainloop`: GEMM_TMA or GEMM_COPY instead of gemm_mainloop's choice
    (for measurements; GEMM_TMA raises for operands it cannot take).
    `slabs`: sum each 64-deep k tile apart on the TMA mainloop
    (GEMM_TMA_SLABS: fp32-accurate over long K); raises where that
    mainloop cannot take the operands."""
    _cuda(a, b, bias, pre, res, ls, out)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("gemm operands must be bfloat16")
    batched = a.dim() == 3
    z = a.shape[0] if batched else 1
    m, k = a.shape[-2:]
    n = b.shape[-2] if b_nk else b.shape[-1]
    if (b.shape[-1] if b_nk else b.shape[-2]) != k:
        raise ValueError(f"gemm inner dims differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, b_nk={b_nk}")

    def mat(t):
        """(pointer, row stride, batch stride) of a [.., R, C] operand."""
        if t is None:
            return None, 0, 0
        if t.stride(-1) != 1:
            raise ValueError("gemm operands need a unit last stride")
        if t.dim() == 3:
            if t.shape[0] != z:
                raise ValueError("batch sizes differ")
            return t.data_ptr(), t.stride(-2), t.stride(0)
        return t.data_ptr(), t.stride(-2), 0

    shape = ((z,) if batched else ()) + (m, n)
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=a.device)
    elif tuple(out.shape) != shape:
        raise ValueError(f"gemm out {tuple(out.shape)} is not {shape}")
    for t in (pre, res):
        if t is not None and tuple(t.shape[-2:]) != (m, n):
            raise ValueError(f"epilogue operand {tuple(t.shape)} is not "
                             f"[.., {m}, {n}]")
    pa, lda, sa = mat(a)
    pb, ldb, sb = mat(b)
    pc, ldc, sc = mat(out)
    pp, ldp, sp = mat(pre)
    pr, ldr, sr = mat(res)
    bias, ls = _f32(bias), _f32(ls)
    if mainloop is None:
        mainloop = gemm_mainloop(n, z, (pa, lda, sa), (pb, ldb, sb))
    if slabs:
        if mainloop != GEMM_TMA:
            raise ValueError(
                f"gemm slabs run on the TMA mainloop, which does not take "
                f"these operands ([{m}, {k}] x [{k}, {n}], row strides "
                f"{lda} / {ldb}, batch strides {sa} / {sb})")
        mainloop = GEMM_TMA_SLABS
    _call("ec_gemm", pa, lda, sa, pb, ldb, sb, int(b_nk), pc, ldc, sc,
          _dt(out), m, n, k, z, _ptr(bias), pp,
          _dt(pre) if pre is not None else 0, ldp, sp, act, pr,
          _dt(res) if res is not None else 0, ldr, sr, _ptr(ls),
          int(mainloop), _stream())
    launches["gemm_kernel" if mainloop == GEMM_COPY
             else "gemm_tma_kernel"] += 1
    return out


def _ln_out(want, x, dtype):
    """An output of layernorm: None, a new tensor, or the caller's own
    (x's shape, `dtype`, on the card; a 2-D one may have any row stride,
    its rows of unit stride: a column block of a wider buffer; x itself
    where the types agree, written in place)."""
    if want is False or want is None:
        return None
    if want is True:
        return torch.empty(x.shape, dtype=dtype, device=x.device)
    _cuda(want)
    if want.dtype != dtype or want.shape != x.shape \
            or not (want.is_contiguous()
                    or (want.dim() == 2 and want.stride(-1) == 1)):
        raise ValueError("layernorm output buffer does not fit")
    return want


def _ld(t) -> int:
    return t.stride(-2) if t.dim() >= 2 else t.shape[-1]


def layernorm(x: torch.Tensor, gamma, beta, eps: float, *, r=None,
              out_f32=True, out_bf16=False):
    """LN(x + r) over the last dim (any width) with fp32 statistics;
    returns (fp32 or None, bf16 or None). out_f32 / out_bf16: False, True
    (a new tensor) or a tensor to write into (_ln_out)."""
    _cuda(x, r, gamma, beta)
    x = x.contiguous()
    c = x.shape[-1]
    rows = x.numel() // c
    if r is not None:
        if r.shape != x.shape:
            raise ValueError("layernorm residual shape differs")
        r = r.contiguous()
    of = _ln_out(out_f32, x, torch.float32)
    ob = _ln_out(out_bf16, x, torch.bfloat16)
    gamma, beta = _f32(gamma), _f32(beta)
    _call("ec_layernorm", x.data_ptr(), _dt(x), c, _ptr(r),
          _dt(r) if r is not None else 0, c, gamma.data_ptr(),
          beta.data_ptr(), float(eps), _ptr(of),
          _ld(of) if of is not None else c, _ptr(ob),
          _ld(ob) if ob is not None else c, rows, c, _stream())
    launches["layernorm_kernel"] += 1
    return of, ob


def add_pos(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(x) + pos) with pos [N, C] broadcast over x [B, N, C]."""
    _cuda(x, pos)
    x = x.contiguous()
    pos = pos.to(torch.bfloat16).contiguous()
    if tuple(x.shape[1:]) != tuple(pos.shape):
        raise ValueError("add_pos shapes differ")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    _call("ec_add_pos", x.data_ptr(), _dt(x), pos.data_ptr(),
          out.data_ptr(), pos.numel(), x.numel(), _stream())
    launches["add_pos_kernel"] += 1
    return out


# Limits of the attention forward kernels (csrc/kernels.cu): keys a block
# holds in shared memory, 16-key tiles of a row that fit in registers (one
# pass), 16-key tiles per chunk of the two-pass form, shared memory a block
# may use.
ATT_MAX_KEYS, ATT_ROW16, ATT_CH16 = 512, 8, 2
ATT_SMEM_LIMIT = 227 * 1024
# The streaming kernels (csrc/attn_long.cu), which take rows longer than
# the resident kernels hold (ATT_MAX_KEYS; fewer at head dim 128), all
# persistent blocks of ATT_STREAM_WARPS warps (two consumer warpgroups and
# the producer's) walking items of ATT_STREAM_ROWS rows. The forwards
# (attn_long_kernel, train_fwd_long_kernel): query items, key tiles of
# ATT_STREAM_KEYS through a ring of ATT_STREAM_STAGES. The backward pair:
# query items with key tiles (train_bwd_q_long_kernel) and key items with
# query tiles (train_bwd_k_long_kernel) of ATT_BWD_TILE through a ring of
# ATT_BWD_STAGES.
ATT_STREAM_ROWS, ATT_STREAM_KEYS, ATT_STREAM_STAGES = 128, 128, 4
ATT_STREAM_WARPS = 12
ATT_BWD_TILE, ATT_BWD_STAGES = 64, 4
# Head dims the kernels are instantiated at: the resident kernels (eval,
# training forward and backward) and the streaming ones at all three. A
# head dim d runs at the first of them at or above it, its q, k and v laid
# out with zero columns (pad_heads), which leave every score and output
# unchanged: the scale is the caller's, from the true d.
ATT_HEAD_DIMS = (32, 64, 128)


def attention_head_dim(d: int) -> int:
    """The head dim the kernels run a head of d at (ATT_HEAD_DIMS)."""
    if not 1 <= d <= ATT_HEAD_DIMS[-1]:
        raise ValueError(f"attention takes head dims 1..{ATT_HEAD_DIMS[-1]}, "
                         f"got {d}")
    return next(dp for dp in ATT_HEAD_DIMS if dp >= d)


def pad_heads(t: torch.Tensor, num_heads: int, d_pad: int) -> torch.Tensor:
    """[B, N, H*d] -> [B, N, H*d_pad]: each head's d columns, then zeros
    (t itself where d == d_pad). The plain version of what the kernels of
    a padded head dim read."""
    b, n, c = t.shape
    d = c // num_heads
    if d == d_pad:
        return t
    out = t.new_zeros((b, n, num_heads, d_pad))
    out[..., :d] = t.reshape(b, n, num_heads, d)
    return out.view(b, n, num_heads * d_pad)


def unpad_heads(t: torch.Tensor, num_heads: int, d: int) -> torch.Tensor:
    """[B, N, H*d_pad] -> [B, N, H*d]: each head's first d columns (t
    itself where d == d_pad)."""
    b, n, cp = t.shape
    dp = cp // num_heads
    if dp == d:
        return t
    return t.view(b, n, num_heads, dp)[..., :d].reshape(b, n, num_heads * d)


def _stream_layout(d: int) -> tuple:
    """(query slots, ring stages) of the streaming forwards at head dim d
    (attn_long.cu AlTile): at head dim 128 a stage takes 65 KB, so the
    ring holds two."""
    return (2, 2) if d == 128 else (2, ATT_STREAM_STAGES)


def _bwd_layout(d: int) -> tuple:
    """(item slots, ring stages) of the streaming backward pair
    (attn_long.cu BwTile): at head dim 128 an item slot takes 64 KB, so
    one is kept beside the ring."""
    return (1 if d == 128 else 2), ATT_BWD_STAGES


def _stream_smem(d: int) -> int:
    """Shared memory of an attn_long_kernel (or train_fwd_long_kernel)
    block: 1024 bytes of alignment slack, the query slots [128 rows x d]
    bf16, the ring (k and v tiles [128 x d] bf16 and 1024 bytes for the
    additive key mask a stage) and 128 bytes of barriers."""
    slots, stages = _stream_layout(d)
    tile = ATT_STREAM_ROWS * 2 * d
    return 1024 + slots * tile + stages * (2 * tile + 1024) + 128


def _bwd_stream_smem(d: int) -> int:
    """Shared memory of a block of the streaming backward pair: 1024
    bytes of alignment slack, the item slots of two [128 rows x d] bf16
    operands, the ring (two [64 x d] bf16 tiles and 1024 bytes of side data
    a stage: the key mask, or each query's statistics and delta) and 128
    bytes of barriers."""
    slots, stages = _bwd_layout(d)
    row = 2 * d
    return 1024 + slots * 2 * ATT_STREAM_ROWS * row \
        + stages * (2 * ATT_BWD_TILE * row + 1024) + 128


def _max_warps(d: int, chunk_tiles: int) -> int:
    """Warps (16-row query tiles) a block may have. One pass: a block's
    keys are few (at most 128, 20 KB of shared memory with the values), so
    four warps a block let many blocks share an SM and split small batches
    finely. Two passes: the keys and values of a head take 59..147 KB
    (up to 227 KB at head dim 128), read again by each block of the
    split, so a block takes as many tiles as let two blocks share an SM's
    registers."""
    if chunk_tiles == ATT_ROW16:
        return 4
    return {32: 12, 64: 9}.get(d, 4)


def _streams(nk: int, chunk_tiles, long: bool) -> bool:
    """Whether a row of nk keys takes the streaming kernels: above
    ATT_MAX_KEYS, or when `long` forces them; chunk_tiles forces the
    resident ones, which hold at most ATT_MAX_KEYS."""
    if chunk_tiles is None:
        return long or nk > ATT_MAX_KEYS
    if long or nk > ATT_MAX_KEYS:
        raise ValueError(f"chunk_tiles picks the resident kernels, which "
                         f"hold at most {ATT_MAX_KEYS} keys (Nk={nk}, "
                         f"long={long})")
    return False


def _padded(plan: tuple, dp: int, d: int) -> tuple:
    return plan + ((("d_pad", dp),) if dp != d else ())


def _stream_plan(nq: int, nk: int, dp: int, d: int) -> tuple:
    return _padded((("long", True), ("q_split", -(-nq // ATT_STREAM_ROWS)),
                    ("warps", ATT_STREAM_WARPS), ("one_pass", True),
                    ("smem_bytes", _stream_smem(dp)),
                    ("key_tiles", -(-nk // ATT_STREAM_KEYS)),
                    ("stages", _stream_layout(dp)[1])), dp, d)


@functools.lru_cache(maxsize=None)
def _attention_plan(nq, nk, d, train, chunk_tiles, long):
    dp = attention_head_dim(d)
    if nq < 1 or nk < 1:
        raise ValueError(f"attention takes at least one query and one key, "
                         f"got Nq={nq}, Nk={nk}")
    key_tiles = -(-nk // 16)
    if _streams(nk, chunk_tiles, long):
        return _stream_plan(nq, nk, dp, d)
    chosen = chunk_tiles is not None
    fits = key_tiles <= ATT_ROW16
    if chunk_tiles is None:
        chunk_tiles = ATT_ROW16 if fits else ATT_CH16
    elif chunk_tiles not in (ATT_ROW16, ATT_CH16):
        raise ValueError(f"chunks of {ATT_ROW16} or {ATT_CH16} key tiles, "
                         f"got {chunk_tiles}")
    elif chunk_tiles == ATT_ROW16 and not fits:
        raise ValueError(f"{nk} keys do not fit one pass "
                         f"({ATT_ROW16 * 16} at most)")
    tiles = -(-nq // 16)
    kld, nkp = dp + 8, key_tiles * 16
    # fewer warps a block where a head's keys and values leave no room
    # for more query tiles (head dim 128 above 320 keys)
    for cap in range(_max_warps(dp, chunk_tiles), 0, -1):
        q_split = -(-tiles // cap)
        warps = -(-tiles // q_split)
        smem = 4 * nkp * kld + 32 * warps * kld + 4 * nkp
        if smem <= ATT_SMEM_LIMIT:
            break
    if smem > ATT_SMEM_LIMIT and not chosen:
        # more keys than a block holds (head dim 128 above 416): streamed
        return _stream_plan(nq, nk, dp, d)
    if smem > ATT_SMEM_LIMIT or q_split > 65535:
        raise ValueError(f"attention plan does not fit: {smem} bytes of "
                         f"shared memory, query split {q_split} (Nk={nk}, "
                         f"head dim {d} run at {dp})")
    return _padded((("q_split", q_split), ("warps", warps),
                    ("one_pass", chunk_tiles == ATT_ROW16),
                    ("smem_bytes", smem), ("key_tiles", key_tiles),
                    ("chunk_tiles", chunk_tiles)), dp, d)


def attention_plan(nq: int, nk: int, d: int, train: bool = False,
                   chunk_tiles=None, long: bool = False) -> dict:
    """The launch plan of the attention forward kernels for Nq queries, Nk
    keys and head dim d (for the training forward), from the shapes alone,
    so equal shapes always run the same way:

    * q_split, warps: a warp owns one 16-row query tile; block y of the
      q_split blocks of a (batch, head) takes tiles [y * warps,
      (y + 1) * warps);
    * one_pass: the key row (key_tiles 16-key tiles) fits in registers, so
      scores are formed once; else two passes over chunks of chunk_tiles
      tiles. `chunk_tiles=2` forces two passes where one would do (for
      measurements);
    * smem_bytes: keys and values [key_tiles * 16, d + 8] bf16, a query
      tile per warp, the additive key mask.

    Above ATT_MAX_KEYS keys, at head dim 128 above the 416 keys a
    resident block holds, or with `long=True` (for measurements), the plan
    is the streaming kernels' and holds `long`: True, the same for the
    eval forward (attn_long_kernel) and the training one
    (train_fwd_long_kernel): q_split items of ATT_STREAM_ROWS query rows a
    (batch, head), blocks of `warps` = ATT_STREAM_WARPS, one pass over
    key_tiles tiles of ATT_STREAM_KEYS keys through a ring of `stages` (2
    at head dim 128, else ATT_STREAM_STAGES), and smem_bytes
    (_stream_smem). Every shape a resident block holds gets the resident
    kernels' plan.

    A head dim other than 32, 64 or 128 runs at the next of them
    (attention_head_dim): the plan then holds `d_pad`, the head dim the
    kernel is launched at, over q, k, v laid out by pad_heads.

    Raises for what the kernels do not take: d outside 1..128, no query
    or key, chunk_tiles with more keys than a resident block holds or with
    `long`."""
    return dict(_attention_plan(int(nq), int(nk), int(d), bool(train),
                                chunk_tiles, bool(long)))


def _plan_args(plan: dict) -> list:
    if plan.get("long"):
        return [plan["q_split"], plan["warps"], plan["smem_bytes"]]
    return [plan["q_split"], plan["warps"], plan["chunk_tiles"],
            plan["smem_bytes"]]


BWD_MAX_WARPS = 8          # 16-row tiles a block of the backward takes


def _bwd_split(tiles: int, resident_tiles: int, smem):
    """(split, warps) of `tiles` 16-row tiles over blocks: blocks of at
    most 4 warps where the resident operand is short (up to 128 rows: cheap
    to copy again, and small batches then still fill the card), else of at
    most BWD_MAX_WARPS; fewer where smem(warps), a block's shared memory,
    would exceed ATT_SMEM_LIMIT (head dim 128)."""
    cap = 4 if resident_tiles <= ATT_ROW16 else BWD_MAX_WARPS
    while True:
        split = -(-tiles // cap)
        warps = -(-tiles // split)
        if cap == 1 or smem(warps) <= ATT_SMEM_LIMIT:
            return split, warps
        cap -= 1


def _bwd_stream_plan(nq: int, nk: int, dp: int, d: int) -> tuple:
    smem = _bwd_stream_smem(dp)
    return _padded((("long", True), ("q_split", -(-nq // ATT_STREAM_ROWS)),
                    ("q_warps", ATT_STREAM_WARPS), ("one_pass", True),
                    ("q_smem_bytes", smem),
                    ("k_split", -(-nk // ATT_STREAM_ROWS)),
                    ("k_warps", ATT_STREAM_WARPS), ("k_smem_bytes", smem),
                    ("q_tiles", -(-nq // ATT_BWD_TILE)),
                    ("key_tiles", -(-nk // ATT_BWD_TILE)),
                    ("stages", _bwd_layout(dp)[1])), dp, d)


@functools.lru_cache(maxsize=None)
def _attention_bwd_plan(nq, nk, d, chunk_tiles, long):
    dp = attention_head_dim(d)
    if nq < 1 or nk < 1:
        raise ValueError(f"the attention backward takes at least one query "
                         f"and one key, got Nq={nq}, Nk={nk}")
    if _streams(max(nq, nk), chunk_tiles, long):
        return _bwd_stream_plan(nq, nk, dp, d)
    chosen = chunk_tiles is not None
    q_tiles, key_tiles = -(-nq // 16), -(-nk // 16)
    fits = key_tiles <= ATT_ROW16
    if chunk_tiles is None:
        chunk_tiles = ATT_ROW16 if fits else ATT_CH16
    elif chunk_tiles not in (ATT_ROW16, ATT_CH16):
        raise ValueError(f"chunks of {ATT_ROW16} or {ATT_CH16} key tiles, "
                         f"got {chunk_tiles}")
    elif chunk_tiles == ATT_ROW16 and not fits:
        raise ValueError(f"{nk} keys do not fit one pass "
                         f"({ATT_ROW16 * 16} at most)")
    kld = dp + 8

    def q_need(warps):
        return 4 * key_tiles * 16 * kld + 64 * warps * kld + 4 * key_tiles * 16

    def k_need(warps):
        return 4 * q_tiles * 16 * kld + 16 * q_tiles * 16 + 64 * warps * kld

    q_split, q_warps = _bwd_split(q_tiles, key_tiles, q_need)
    k_split, k_warps = _bwd_split(key_tiles, q_tiles, k_need)
    q_smem, k_smem = q_need(q_warps), k_need(k_warps)
    if max(q_smem, k_smem) > ATT_SMEM_LIMIT and not chosen:
        # more rows than a block holds (head dim 128 from about 400):
        # streamed
        return _bwd_stream_plan(nq, nk, dp, d)
    if max(q_smem, k_smem) > ATT_SMEM_LIMIT:
        raise ValueError(f"attention backward plan does not fit: {q_smem} "
                         f"and {k_smem} bytes of shared memory (Nq={nq}, "
                         f"Nk={nk}, head dim {d} run at {dp})")
    return _padded((("q_split", q_split), ("q_warps", q_warps),
                    ("one_pass", chunk_tiles == ATT_ROW16),
                    ("chunk_tiles", chunk_tiles), ("q_smem_bytes", q_smem),
                    ("k_split", k_split), ("k_warps", k_warps),
                    ("k_smem_bytes", k_smem), ("q_tiles", q_tiles),
                    ("key_tiles", key_tiles)), dp, d)


def attention_bwd_plan(nq: int, nk: int, d: int, chunk_tiles=None,
                       long: bool = False) -> dict:
    """The launch plan of the training attention's backward, from the
    shapes alone. Two kernels, each with a warp per 16-row tile and the
    tiles of a (batch, head) split over gridDim.y:

    * query-major (dq, dbias, delta): block y of q_split takes query tiles
      [y * q_warps, (y + 1) * q_warps); keys and values ([key_tiles * 16,
      d + 8] bf16 each), a query and a do tile per warp and the additive
      key mask lie in q_smem_bytes of shared memory; one_pass: the key row
      fits in registers, else two passes over chunks of chunk_tiles tiles
      (`chunk_tiles=2` forces them, for measurements);
    * key-major (dk, dv): block y of k_split takes key tiles [y * k_warps,
      (y + 1) * k_warps); queries and do ([q_tiles * 16, d + 8] each), 16
      bytes of statistics a query and a key and a value tile per warp lie
      in k_smem_bytes.

    Above ATT_MAX_KEYS queries or keys, at head dim 128 where the
    resident kernels' blocks would not hold the rows (from about 400), or
    with `long=True` (for measurements), the plan is the streaming pair's
    and holds `long`: True:
    train_bwd_q_long_kernel walks q_split items of ATT_STREAM_ROWS query
    rows a (batch, head) with key_tiles tiles of ATT_BWD_TILE keys (and
    values) streamed, train_bwd_k_long_kernel k_split items of
    ATT_STREAM_ROWS keys with q_tiles tiles of ATT_BWD_TILE queries (and
    do) streamed, both one pass through a ring of `stages`, in blocks of
    q_warps = k_warps = ATT_STREAM_WARPS warps with q_smem_bytes =
    k_smem_bytes (_bwd_stream_smem) of shared memory (one item slot at
    head dim 128, two below).

    A head dim other than 32, 64 or 128 holds `d_pad` as attention_plan's.

    Raises for what the kernels do not take: d outside 1..128, no query
    or key, chunk_tiles with more rows than the resident kernels hold or
    with `long`."""
    return dict(_attention_bwd_plan(int(nq), int(nk), int(d), chunk_tiles,
                                    bool(long)))


def _bwd_plan_args(plan: dict) -> list:
    if plan.get("long"):
        return [plan["q_split"], plan["q_warps"], plan["q_smem_bytes"],
                plan["k_split"], plan["k_warps"], plan["k_smem_bytes"]]
    return [plan["q_split"], plan["q_warps"], plan["chunk_tiles"],
            plan["q_smem_bytes"], plan["k_split"], plan["k_warps"],
            plan["k_smem_bytes"]]


def _key_mask(key_valid, b: int, nk: int):
    """The bool key mask [B, Nk] as the kernels read it (one byte a key,
    unit last stride): (tensor kept alive, pointer, batch stride)."""
    if key_valid is None:
        return None, None, 0
    if key_valid.dtype != torch.bool or tuple(key_valid.shape) != (b, nk):
        raise ValueError(f"key mask must be bool [{b}, {nk}], got "
                         f"{key_valid.dtype} {tuple(key_valid.shape)}")
    if key_valid.stride(-1) != 1:
        key_valid = key_valid.contiguous()
    return key_valid, key_valid.data_ptr(), key_valid.stride(0)


def _f32_contiguous(t):
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.to(torch.float32).contiguous()
    return t


def _long_name(kernel: str, dp: int) -> str:
    """The launch counter of a streaming kernel's instance at head dim dp:
    the head-dim-128 instances are counted apart ("attn_long_kernel<128>"),
    those at 32 and 64 under the kernel's name."""
    return f"{kernel}<128>" if dp == 128 else kernel


def _stream_operand(t: torch.Tensor) -> torch.Tensor:
    """An operand of attn_long_kernel, whose TMA maps read bf16 views with
    16-byte-aligned base and strides: fp32 is rounded to bf16 here, as the
    TPU kernel casts its operands at the call, and a view a map cannot
    describe is copied."""
    if t.dtype != torch.bfloat16:
        return t.to(torch.bfloat16).contiguous()
    if not tma_operand_ok(t.data_ptr(), t.stride(1), t.stride(0), t.shape[0]):
        return t.contiguous()
    return t


def attention(q, k, v, *, num_heads: int, scale: float, key_valid=None,
              bias=None, out_dtype=torch.bfloat16, out=None,
              plan=None) -> torch.Tensor:
    """Multi-head attention on [B, N, H*D] views (unit last stride):
    softmax(q k^T * scale + key mask[b] + bias[b, h]) v per head, output
    [B, Nq, H*D] rounded to bf16 (stored as out_dtype, or into `out`).
    key_valid: [B, Nk] bool, False keys are masked (read by the kernel);
    bias: [B, H, Nq, Nk] fp32. One launch of attn_kernel, or of
    attn_long_kernel where the plan streams the keys (its operands as
    _stream_operand gives them; the scale must be positive); `plan`
    overrides attention_plan (for measurements). Where the plan pads the
    head dim (`d_pad`), q, k and v are laid out by pad_heads and the
    result's padding columns dropped."""
    _cuda(q, k, v, key_valid, bias, out)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ")
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("attention operands need a unit last stride")
    key_valid, kv_ptr, kv_stride = _key_mask(key_valid, b, nk)
    if bias is not None:
        bias = _f32_contiguous(bias)
        if tuple(bias.shape) != (b, num_heads, nq, nk):
            raise ValueError(f"bias shape {tuple(bias.shape)}")
    if plan is None:
        plan = attention_plan(nq, nk, d)
    if out is not None and (tuple(out.shape) != (b, nq, c)
                            or out.stride(-1) != 1):
        raise ValueError(f"attention out {tuple(out.shape)}")
    dp = plan.get("d_pad", d)
    res = out
    if dp != d:
        q, k, v = (pad_heads(t, num_heads, dp) for t in (q, k, v))
        res = None
    if res is None:
        res = torch.empty((b, nq, num_heads * dp),
                          dtype=out_dtype if out is None else out.dtype,
                          device=q.device)
    long = bool(plan.get("long"))
    if long:
        q, k, v = (_stream_operand(t) for t in (q, k, v))
    _call("ec_attention_long" if long else "ec_attention", q.data_ptr(),
          k.data_ptr(), v.data_ptr(), _dt(q), q.stride(0), q.stride(1),
          k.stride(0), k.stride(1), v.stride(0), v.stride(1), b, num_heads,
          dp, nq, nk, kv_ptr, kv_stride, _ptr(bias), float(scale),
          res.data_ptr(), _dt(res), res.stride(0), res.stride(1),
          *_plan_args(plan), _stream())
    launches[_long_name("attn_long_kernel", dp) if long
             else "attn_kernel"] += 1
    if dp == d:
        return res
    res = unpad_heads(res, num_heads, d)
    if out is None:
        return res
    out.copy_(res)
    return out


def sine_feats(ct: torch.Tensor, rdt: torch.Tensor) -> torch.Tensor:
    """Normalised (x, y) coordinates ct [R, 2] fp32 -> bf16 [R, 4F] sine
    features [sin_y | cos_y | sin_x | cos_x], angle = (c * 2 pi) * rdt
    with rdt [F] fp32 the reciprocal temperatures."""
    _cuda(ct, rdt)
    if ct.dtype != torch.float32 or rdt.dtype != torch.float32 \
            or ct.dim() != 2 or ct.shape[1] != 2 \
            or not ct.is_contiguous() or not rdt.is_contiguous():
        raise ValueError("sine_feats takes contiguous fp32 [R, 2] and [F]")
    rows, f = ct.shape[0], rdt.numel()
    out = torch.empty((rows, 4 * f), dtype=torch.bfloat16, device=ct.device)
    _call("ec_sine_feats", ct.data_ptr(), rdt.data_ptr(), out.data_ptr(),
          rows, f, _stream())
    launches["sine_feats_kernel"] += 1
    return out


def dropout_threshold(rate: float):
    """(keep threshold on 32 random bits, 1 / (1 - rate)): an element is
    kept when its bits are >= the threshold; 0 switches dropout off."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if rate == 0.0:
        return 0, 1.0
    return min(int(rate * 2 ** 32), 2 ** 32 - 1), 1.0 / (1.0 - rate)


def _seed_ptr(seed, thresh):
    """Device pointer of the one-element int64 seed tensor (None without
    dropout)."""
    if not thresh:
        return None
    if seed is None or not seed.is_cuda or seed.dtype != torch.int64 \
            or seed.numel() != 1:
        raise ValueError("dropout needs a one-element int64 CUDA seed tensor")
    return seed.data_ptr()


def _train_head(q, k, v, num_heads, scale, key_valid, bias, seed, rate):
    """Checks and the leading arguments shared by the two training
    attention entry points; returns (args, tensors kept alive by the
    caller)."""
    _cuda(q, k, v, key_valid, bias)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ")
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    if d not in ATT_HEAD_DIMS:
        raise ValueError(f"training attention runs at head dims "
                         f"{ATT_HEAD_DIMS} (pad_heads), got D={d}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("attention operands need a unit last stride")
    key_valid, km_ptr, km_stride = _key_mask(key_valid, b, nk)
    if bias is not None:
        bias = _f32_contiguous(bias)
        if tuple(bias.shape) != (b, num_heads, nq, nk):
            raise ValueError(f"bias shape {tuple(bias.shape)}")
    thresh, inv_keep = dropout_threshold(rate)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), _dt(q), q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            b, num_heads, d, nq, nk, km_ptr, km_stride, _ptr(bias),
            float(scale), _seed_ptr(seed, thresh), thresh, inv_keep]
    return args, (key_valid, bias)


def attention_train_fwd(q, k, v, *, num_heads: int, scale: float,
                        key_valid=None, bias=None, seed=None,
                        rate: float = 0.0, plan=None):
    """Training attention forward on [B, N, H*D] views: returns
    (out fp32 [B, Nq, H*D], stats fp32 [B*H, Nq, 2] = row max and
    reciprocal exp-sum, for the backward). key_valid: [B, Nk] bool, read
    by the kernel. Dropout at `rate` on the probabilities from Philox
    keyed by `seed`, a one-element int64 CUDA tensor. One launch of
    train_fwd_kernel, or of train_fwd_long_kernel where the plan streams
    the keys (its operands as _stream_operand gives them; the scale must
    be positive). A padded head dim (the plan's `d_pad`) runs on q, k, v
    laid out by pad_heads; the output drops the padding columns."""
    _cuda(q, k, v)
    b, nq, c = q.shape
    d = c // num_heads
    if plan is None:
        plan = attention_plan(nq, k.shape[1], d, train=True)
    dp = plan.get("d_pad", d)
    q, k, v = (pad_heads(t, num_heads, dp) for t in (q, k, v))
    long = bool(plan.get("long"))
    if long:
        q, k, v = (_stream_operand(t) for t in (q, k, v))
    args, keep_alive = _train_head(q, k, v, num_heads, scale, key_valid,
                                   bias, seed, rate)
    out = torch.empty((b, nq, num_heads * dp), dtype=torch.float32,
                      device=q.device)
    stats = torch.empty((b * num_heads, nq, 2), dtype=torch.float32,
                        device=q.device)
    _call("ec_attn_train_fwd_long" if long else "ec_attn_train_fwd", *args,
          out.data_ptr(), out.stride(0), out.stride(1), stats.data_ptr(),
          *_plan_args(plan), _stream())
    launches[_long_name("train_fwd_long_kernel", dp) if long
             else "train_fwd_kernel"] += 1
    del keep_alive
    return unpad_heads(out, num_heads, d), stats


def attention_train_bwd(q, k, v, dout, stats, *, num_heads: int,
                        scale: float, key_valid=None, bias=None,
                        seed=None, rate: float = 0.0,
                        need_dbias: bool = True, plan=None, out=None):
    """Training attention backward: (dq, dk, dv fp32 [B, N, H*D], dbias
    fp32 [B, H, Nq, Nk] or None when there is no bias or it is not
    needed), with the dropout mask regenerated from `seed`. key_valid:
    the forward's [B, Nk] bool mask, read by the kernels; dout: [B, Nq,
    H*D] fp32 or bf16 with a unit last stride. Two launches (query-major,
    then key-major: train_bwd_q_kernel and train_bwd_k_kernel, or their
    streaming forms where the plan is long); dq, dk and dv are views of one
    allocation. `plan` overrides attention_bwd_plan (for measurements).
    The streaming pair also takes `out`, the forward's fp32 output [B, Nq,
    H*D] (delta = rowsum(bf16(dout) * out)), and its operands and dout as
    _stream_operand gives them (dout rounded to bf16 once, as the TPU
    kernel casts it); the scale must be positive. A padded head dim (the
    plan's `d_pad`) runs on q, k, v, dout and `out` laid out by
    pad_heads; the gradients drop the padding columns."""
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    if plan is None:
        plan = attention_bwd_plan(nq, nk, d)
    long = bool(plan.get("long"))
    _cuda(q, k, v, dout, stats, out)
    if tuple(dout.shape) != (b, nq, c):
        raise ValueError(f"dout shape {tuple(dout.shape)}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if long and (out is None or tuple(out.shape) != (b, nq, c)
                 or out.dtype != torch.float32 or out.stride(-1) != 1):
        raise ValueError("the streaming backward takes the forward's fp32 "
                         f"output [{b}, {nq}, {c}] as `out`")
    dp = plan.get("d_pad", d)
    if dp != d:
        q, k, v, dout = (pad_heads(t, num_heads, dp) for t in (q, k, v, dout))
        if out is not None:
            out = pad_heads(out, num_heads, dp)
        c = num_heads * dp
    if long:
        q, k, v, dout = (_stream_operand(t) for t in (q, k, v, dout))
    args, keep_alive = _train_head(q, k, v, num_heads, scale, key_valid,
                                   bias, seed, rate)
    bias = keep_alive[1]
    # dq | dk | dv | delta (the row sums the first kernel hands the second)
    nq_el, nk_el = b * nq * c, b * nk * c
    buf = torch.empty(nq_el + 2 * nk_el + b * num_heads * nq,
                      dtype=torch.float32, device=q.device)
    dq = buf[:nq_el].view(b, nq, c)
    dk = buf[nq_el:nq_el + nk_el].view(b, nk, c)
    dv = buf[nq_el + nk_el:nq_el + 2 * nk_el].view(b, nk, c)
    delta = buf[nq_el + 2 * nk_el:]
    dbias = None if bias is None or not need_dbias else torch.empty(
        (b, num_heads, nq, nk), dtype=torch.float32, device=q.device)
    form = "_long" if long else ""
    fwd_out = [out.data_ptr(), out.stride(0), out.stride(1)] if long else []
    _call("ec_attn_train_bwd" + form, *args, dout.data_ptr(), _dt(dout),
          dout.stride(0), dout.stride(1), stats.data_ptr(), *fwd_out,
          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dbias),
          delta.data_ptr(), *_bwd_plan_args(plan), _stream())
    for half in ("q", "k"):
        name = f"train_bwd_{half}{form}_kernel"
        launches[_long_name(name, dp) if long else name] += 1
    del keep_alive
    dq, dk, dv = (unpad_heads(t, num_heads, d) for t in (dq, dk, dv))
    return dq, dk, dv, dbias


def dropout_mask(seed: torch.Tensor, rate: float, bh: int, nq: int,
                 nk: int) -> torch.Tensor:
    """The keep mask the training attention kernels draw for (seed, rate):
    bool [bh, nq, nk] on the seed's device."""
    thresh, _ = dropout_threshold(rate)
    keep = torch.empty((bh, nq, nk), dtype=torch.uint8, device=seed.device)
    _call("ec_dropout_mask", _seed_ptr(seed, thresh), thresh, bh, nq, nk,
          keep.data_ptr(), _stream())
    launches["dropout_mask_kernel"] += 1
    return keep.bool()


def module_weights(module, attr: str, build, *extra):
    """build(module): a module's weights in the form its kernels take (bf16
    matrices, concatenations, fp32 vectors), made once and kept in
    `module.<attr>` until a parameter is replaced, written in place or
    cast, or `extra` changes."""
    key = extra + tuple((p.data_ptr(), p._version, p.dtype)
                        for p in module.parameters())
    cached = getattr(module, attr, None)
    if cached is not None and cached[0] == key:
        return cached[1]
    weights = build(module)
    setattr(module, attr, (key, weights))
    return weights


# The post-attention layer kernels (csrc/kernels.cu enc_post_kernel,
# dec_post_self_kernel, dec_post_cross_kernel): rows of POST_C channels in
# tiles of POST_TILE rows; the encoder's FFN hidden in chunks of ENC_CHUNK
# columns, the decoder's GCN width in chunks of DEC_CHUNK.
POST_C, POST_TILE, ENC_CHUNK, DEC_CHUNK = 256, 128, 128, 64
# Their companions at every other width, up to WIDE_MAX_C channels, in
# shared memory of at most ATT_SMEM_LIMIT a block. Above it, where a
# 64-row tile's channels no longer fit a block's registers and shared
# memory, the split route: each step of the post-attention work and of the
# keypoint head a launch of the port's own kernels (the GEMM with its
# epilogue, layernorm_kernel, add_pos_kernel, kpt_coord_kernel), the
# activations between them in device memory (post_plan, kpt_head_plan).
WIDE_MAX_C = 512
# enc_post_wide_kernel (csrc/head_wide.cu) and the decoder's
# dec_post_self_wide_kernel, dec_post_cross_wide_kernel and
# dec_post_gcn_wide_kernel (csrc/dec_wide.cuh): tiles of ENC_WIDE_TILE
# rows, each of their two consumer warpgroups holding half the channels
# rounded up to 64 (enc_wide_half), hidden widths in chunks of
# ENC_WIDE_CHUNK, the weights through a ring of at most ENC_WIDE_SLOTS
# slots a warpgroup (the decoder's of WIDE_BOX bytes, one [64 x 64] bf16
# box), in ATT_SMEM_LIMIT bytes of shared memory (head_wide.cu ew_smem,
# dec_wide.cuh dw_smem).
ENC_WIDE_TILE, ENC_WIDE_CHUNK, ENC_WIDE_SLOTS, WIDE_BOX = 64, 128, 8, 8192
# dec_post_gcn_wide_kernel's adjacency window in boxes (dec_adj_window)
DEC_ADJ_SHORT, DEC_ADJ_LONG = 4, 10


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def enc_wide_half(c: int) -> int:
    """The channels each consumer warpgroup of enc_post_wide_kernel and
    the decoder's wide kernels holds: half of c rounded up to 64 (64, 128,
    192 or 256; one instance each)."""
    return _up(-(-c // 2), 64)


def enc_wide_ring(c: int) -> tuple:
    """(slots of each warpgroup's weight ring, shared-memory bytes) of
    enc_post_wide_kernel at c channels: alignment slack, the x tile
    [64, 2 nh] bf16, two buffers of a hidden chunk [64, 128] bf16, the
    LayerNorm's partial sums, then the two rings of nh x 128-byte slots
    (as many as fit, at most ENC_WIDE_SLOTS) with two barriers a slot."""
    nh = enc_wide_half(c)
    fixed = 1024 + nh * 256 + 4 * 8192 + 4 * 2 * 2 * ENC_WIDE_TILE
    slots = min(ENC_WIDE_SLOTS,
                (ATT_SMEM_LIMIT - fixed) // (2 * (nh * 128 + 16)))
    return slots, fixed + 2 * slots * (nh * 128 + 16)


def dec_adj_window(keypoints: int) -> int:
    """Adjacency boxes [64 rows x 64 keys] that dec_post_gcn_wide_kernel
    keeps (csrc/dec_wide.cuh dw_adj_window): DEC_ADJ_SHORT up to two key
    boxes a batch row (K <= 128), DEC_ADJ_LONG above, which hold a tile's
    2 ceil(K / 64) boxes up to K = 320 and a window of them past that."""
    return DEC_ADJ_SHORT if -(-keypoints // 64) <= 2 else DEC_ADJ_LONG


def dec_wide_rings(c: int, keypoints: int = POST_TILE) -> dict:
    """{kernel: (slots of each warpgroup's weight ring, shared-memory
    bytes)} of the decoder's wide kernels at c channels and `keypoints` a
    batch row (csrc/dec_wide.cuh dw_smem): alignment slack, the boxes each
    keeps (the self kernel's att, then bf16(x1), and qpos, [64, 2 nh] bf16
    each; the cross kernel's att2 [64, 4 nh], then bf16(x2) over it, and
    two o2 chunks [64, 128]; the gcn kernel's adjacency window of
    dec_adj_window boxes and two relu(m) chunks), the LayerNorm's partial
    sums, then the two rings of WIDE_BOX slots (as many as fit, at most
    ENC_WIDE_SLOTS) with two barriers a slot. At 512 channels: 6, 4 and 8
    slots (7 for the gcn kernel above 128 keypoints)."""
    nh = enc_wide_half(c)
    red = 4 * 2 * 2 * ENC_WIDE_TILE
    fixed = {"dec_post_self_wide_kernel": 1024 + 2 * nh * 256 + red,
             "dec_post_cross_wide_kernel": 1024 + nh * 512 + 4 * WIDE_BOX
             + red,
             "dec_post_gcn_wide_kernel": 1024 + (dec_adj_window(keypoints)
                                                 + 4) * WIDE_BOX + red}
    rings = {}
    for name, f in fixed.items():
        slots = min(ENC_WIDE_SLOTS,
                    (ATT_SMEM_LIMIT - f) // (2 * (WIDE_BOX + 16)))
        rings[name] = (slots, f + 2 * slots * (WIDE_BOX + 16))
    return rings


@functools.lru_cache(maxsize=None)
def dec_wide_card_rings(c: int, keypoints: int = POST_TILE) -> dict:
    """dec_wide_rings as the built kernels take them: the slots and shared
    memory that csrc/dec_wide.cu's launches compute at c channels and
    `keypoints` a batch row."""
    out = (ctypes.c_int * 6)()
    _call("ec_dec_wide_layout", c, keypoints, ctypes.addressof(out))
    names = ("dec_post_self_wide_kernel", "dec_post_cross_wide_kernel",
             "dec_post_gcn_wide_kernel")
    return {n: (out[2 * i], out[2 * i + 1]) for i, n in enumerate(names)}


def split_refusal(c: int, f: Optional[int] = None) -> Optional[str]:
    """Why the split route above WIDE_MAX_C channels does not take c
    channels with a hidden of f (None: it does). Its every product runs on
    gemm's slab mainloop, which reads its operands through tensor maps:
    each row stride and column offset (c, 2 c, f, 2 f) a multiple of 8
    elements, each output (f the narrowest) GEMM_TMA_MIN_N wide or more."""
    if c % 8:
        return f"the split route takes channels in multiples of 8, got {c}"
    if f is not None and (f % 8 or f < GEMM_TMA_MIN_N):
        return (f"the split route takes hidden widths in multiples of 8 "
                f"from {GEMM_TMA_MIN_N}, got {f}")
    return None


def post_plan(rows: int, c: int, f: int, *, chunk: int = ENC_CHUNK,
              keypoints: Optional[int] = None) -> dict:
    """How a post-attention kernel covers `rows` token rows of c channels
    with a hidden of width f. At POST_C channels: `tiles` of POST_TILE
    rows, whose `pad_rows` missing rows (the last tile's) the TMA fills with
    zeros and the kernel does not store, and `chunks` of the hidden, which
    is padded to `f_pad` columns (a multiple of `chunk`) where f is not one.
    With `keypoints` (the decoder's cross kernel) up to POST_TILE: a tile
    is one batch row of K keypoints, padded to POST_TILE rows with zero
    rows and zero adjacency columns.

    Any other c up to WIDE_MAX_C, and with more than POST_TILE keypoints
    every c up to it (256 too), takes the wide kernels, and the plan
    holds `wide`: True and their common layout: `tiles` of ENC_WIDE_TILE
    rows over the rows flattened (`pad_rows` missing in the last), the
    warpgroups' `half` channels each (enc_wide_half), the weights'
    padded widths `c_pad` (2 half), `c2_pad` (for 2C: 2 c_pad) and
    `f_pad` (f in `chunks` chunks of ENC_WIDE_CHUNK), so that every box
    their TMA reads lies inside them; `kernels`: each kernel of the
    plan's launch by name with its `slots` a warpgroup and `smem_bytes`
    (dec_wide_rings, enc_wide_ring), and the largest as `smem_bytes`.
    Without `keypoints`: dec_post_self_wide_kernel and
    enc_post_wide_kernel; with them: the cross layer's two launches, dec_post_cross_wide_kernel
    over the `tiles` and dec_post_gcn_wide_kernel over `gcn_tiles` of
    ENC_WIDE_TILE rows of one batch row each (ceil(K / 64) a batch row,
    `gcn_pad_rows` missing in a batch row's last; its adjacency window of
    `adj_boxes` boxes, dec_adj_window). The padding columns are zero in
    the weights (pad_cols, pad_ffn, pad_gcn), so the products are
    unchanged.

    Above WIDE_MAX_C channels, at any keypoint count, the split route
    (`split`: True): each op a chain of gemm's slab products and
    layernorm launches, the weights not padded; it takes c and f as
    split_refusal says. Raises for what the kernels do not take: no
    channels, no hidden, no rows, no keypoints or no whole batch rows of
    them, a split width split_refusal names."""
    if c < 1:
        raise ValueError(f"the post-attention kernels take 1 channel or "
                         f"more, got {c}")
    if f <= 0:
        raise ValueError(f"no hidden width ({f})")
    if rows <= 0:
        raise ValueError(f"no rows ({rows})")
    if keypoints is not None and (keypoints < 1 or rows % keypoints):
        raise ValueError(f"{rows} rows are no batch of rows of keypoints "
                         f"(K={keypoints})")
    if c > WIDE_MAX_C:
        why = split_refusal(c, f)
        if why:
            raise ValueError(why)
        return {"split": True}
    if c != POST_C or (keypoints or 0) > POST_TILE:
        half, f_pad = enc_wide_half(c), _up(f, ENC_WIDE_CHUNK)
        tiles = -(-rows // ENC_WIDE_TILE)
        rings = dec_wide_rings(c, keypoints or POST_TILE)
        names = (("dec_post_cross_wide_kernel", "dec_post_gcn_wide_kernel")
                 if keypoints else ("dec_post_self_wide_kernel",))
        kernels = {n: {"slots": rings[n][0], "smem_bytes": rings[n][1]}
                   for n in names}
        plan = {"wide": True, "half": half, "c_pad": 2 * half,
                "c2_pad": 4 * half, "f_pad": f_pad,
                "chunks": f_pad // ENC_WIDE_CHUNK, "tiles": tiles,
                "pad_rows": tiles * ENC_WIDE_TILE - rows, "kernels": kernels}
        if keypoints:
            kt = -(-keypoints // ENC_WIDE_TILE)
            plan.update(gcn_tiles=rows // keypoints * kt,
                        gcn_pad_rows=kt * ENC_WIDE_TILE - keypoints,
                        adj_boxes=dec_adj_window(keypoints))
        else:
            slots, enc_smem = enc_wide_ring(c)
            kernels["enc_post_wide_kernel"] = {"slots": slots,
                                               "smem_bytes": enc_smem}
        plan["smem_bytes"] = max(k["smem_bytes"] for k in kernels.values())
        return plan
    f_pad = _up(f, chunk)
    if keypoints is None:
        tiles = -(-rows // POST_TILE)
        plan = {"tiles": tiles, "chunks": f_pad // chunk,
                "pad_rows": tiles * POST_TILE - rows}
    else:
        plan = {"tiles": rows // keypoints, "chunks": f_pad // chunk,
                "pad_rows": POST_TILE - keypoints}
    if f_pad != f:
        plan["f_pad"] = f_pad
    return plan


def pad_cols(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A matrix [r, c] inside a zero [rows, cols] one (w itself where it
    has that shape): the layout of a padded weight."""
    if tuple(w.shape) == (rows, cols):
        return w
    out = w.new_zeros((rows, cols))
    out[:w.shape[0], :w.shape[1]] = w
    return out


def pad_ffn(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
            f_pad: int, c_pad: Optional[int] = None):
    """The FFN relu(x W1^T + b1) W2^T with its hidden padded to f_pad:
    zero rows of W1 [F, C] and b1, zero columns of W2 [C, F], exact under
    ReLU; with c_pad also the channels (W1's columns, W2's rows)."""
    c_pad = w1.shape[1] if c_pad is None else c_pad
    return (pad_cols(w1, f_pad, c_pad), pad_cols(b1[None], 1, f_pad)[0],
            pad_cols(w2, c_pad, f_pad))


def pad_gcn(wg: torch.Tensor, bg: torch.Tensor, wf: torch.Tensor,
            f_pad: int, c_pad: Optional[int] = None):
    """The GCN conv [2F, C] (slices y0 | y1 of F rows each) and its bias,
    each slice padded to f_pad zero rows, and ffn2 [C, F] to f_pad zero
    columns: m = adj0 . y0 + adj1 . y1 then relu and ffn2 are unchanged;
    with c_pad also the channels."""
    f = wg.shape[0] // 2
    c_pad = wg.shape[1] if c_pad is None else c_pad
    wgp = torch.cat([pad_cols(wg[:f], f_pad, c_pad),
                     pad_cols(wg[f:], f_pad, c_pad)])
    bgp = torch.cat([pad_cols(bg[None, :f], 1, f_pad)[0],
                     pad_cols(bg[None, f:], 1, f_pad)[0]])
    return wgp, bgp, pad_cols(wf, c_pad, f_pad)


def _operand(t: torch.Tensor, shape, dtype=torch.bfloat16,
             align: int = 16) -> int:
    """Address of a kernel operand that must be a contiguous CUDA tensor
    of this shape and type, aligned to `align` bytes."""
    _cuda(t)
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"kernel operand: need contiguous aligned {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


def _vectors(w: dict, *names) -> list:
    return [_operand(w[n], (w[n].numel(),), torch.float32) for n in names]


def enc_post(att: torch.Tensor, src: torch.Tensor, w: dict, *, eps: float,
             out_dtype=None, pos=None):
    """The joint encoder layer after its attention, one launch:
    x = LN1(src + att . wo^T + bo); y = LN2(x + relu(bf16(x) . w1^T + b1)
    . w2^T + b2), the hidden in chunks and the second product accumulated
    onto x. att, src: contiguous bf16 [R, C]; w: the layer's weights
    (wo, bo, g1, be1, w1, b1, w2, b2, g2, be2; ops/fused_encoder.py
    _prepare, in post_plan's layout: at POST_C the hidden padded to
    f_pad, elsewhere wo, w1, w2 and b1 padded to c_pad channels and
    f_pad hidden columns). Returns (y [R, C] in out_dtype, or
    None when out_dtype is None; with pos [N, C] bf16, the next layer's
    src = bf16(bf16(y) + pos[row % N]) bf16 [R, C], else None).
    enc_post_kernel at POST_C channels, enc_post_wide_kernel at the
    others up to WIDE_MAX_C, the split route above (post_plan: five
    launches, six with pos)."""
    r, c = att.shape
    f = w["w1"].shape[0]
    plan = post_plan(r, c, f)
    if out_dtype is None and pos is None:
        raise ValueError("enc_post writes y, the next src or both")
    if plan.get("split"):
        return _enc_post_split(att, src, w, eps=eps, out_dtype=out_dtype,
                               pos=pos)
    if plan.get("wide"):
        return _enc_post_wide(att, src, w, plan, eps=eps,
                              out_dtype=out_dtype, pos=pos)
    ptrs = [_operand(att, (r, c)), _operand(src, (r, c)),
            _operand(w["wo"], (c, c))] + _vectors(w, "bo", "g1", "be1") + [
        _operand(w["w1"], (f, c))] + _vectors(w, "b1") + [
        _operand(w["w2"], (c, f))] + _vectors(w, "b2", "g2", "be2")
    out = None if out_dtype is None else torch.empty(
        (r, c), dtype=out_dtype, device=att.device)
    nxt = n_tok = None
    if pos is not None:
        n_tok = pos.shape[0]
        _operand(pos, (n_tok, c))
        nxt = torch.empty((r, c), dtype=torch.bfloat16, device=att.device)
    _call("ec_enc_post", *ptrs, _ptr(pos), n_tok or 0, _ptr(out),
          _dt(out) if out is not None else 0, _ptr(nxt), r, f, float(eps),
          _stream())
    launches["enc_post_kernel"] += 1
    return out, nxt


def _enc_post_wide(att, src, w, plan, *, eps, out_dtype, pos):
    r, c = att.shape
    cp, fp = plan["c_pad"], plan["f_pad"]
    ptrs = [_operand(att, (r, c)), _operand(src, (r, c)),
            _operand(w["wo"], (cp, cp))] + _vectors(w, "bo", "g1", "be1") + [
        _operand(w["w1"], (fp, cp))] + _vectors(w, "b1") + [
        _operand(w["w2"], (cp, fp))] + _vectors(w, "b2", "g2", "be2")
    out = None if out_dtype is None else torch.empty(
        (r, c), dtype=out_dtype, device=att.device)
    nxt = n_tok = None
    if pos is not None:
        n_tok = pos.shape[0]
        _operand(pos, (n_tok, c))
        nxt = torch.empty((r, c), dtype=torch.bfloat16, device=att.device)
    _call("ec_enc_post_wide", *ptrs, _ptr(pos), n_tok or 0, _ptr(out),
          _dt(out) if out is not None else 0, _ptr(nxt), r, c, cp, fp,
          float(eps), _stream())
    launches["enc_post_wide_kernel"] += 1
    return out, nxt


def _enc_post_split(att, src, w, *, eps, out_dtype, pos):
    """enc_post above WIDE_MAX_C channels as its plain version's steps:
    x = LN1(att . wo^T + bo + src), h = bf16(relu(bf16(x) . w1^T + b1)),
    y = LN2(h . w2^T + b2 + x), the fp32 sums LayerNorm-ed in place."""
    r, c = att.shape
    f32 = torch.float32
    mm = functools.partial(gemm, b_nk=True, slabs=True)
    x = mm(att, w["wo"], bias=w["bo"], pre=src, out_dtype=f32)
    _, xb = layernorm(x, w["g1"], w["be1"], eps, out_f32=x, out_bf16=True)
    h = mm(xb, w["w1"], bias=w["b1"], act=ACT_RELU)
    y = mm(h, w["w2"], bias=w["b2"], pre=x, out_dtype=f32)
    del x, xb, h
    bf = out_dtype == torch.bfloat16 or pos is not None
    y, yb = layernorm(y, w["g2"], w["be2"], eps,
                      out_f32=y if out_dtype == f32 else False, out_bf16=bf)
    out = y if out_dtype == f32 else yb if out_dtype is not None else None
    nxt = None
    if pos is not None:
        n_tok = pos.shape[0]
        nxt = add_pos(yb.view(r // n_tok, n_tok, c), pos).view(r, c)
    return out, nxt


def dec_post_self(att: torch.Tensor, xb: torch.Tensor, qpos: torch.Tensor,
                  w: dict, *, eps: float, qin=None):
    """The decoder layer after its self-attention, one launch:
    x1 = LN1(xb + att . wso^T + bso) and the cross-attention's query
    q2 = bf16(bf16(x1) . wcq_x^T + qpos . wcq_p^T + bcq). att, xb, qpos:
    contiguous bf16 [R, C]; w: the layer's weights (ops/fused_decoder.py
    _prepare, in post_plan's layout). Returns (x1 fp32 [R, C], q2 bf16
    [R, 2C]). dec_post_self_kernel at POST_C channels,
    dec_post_self_wide_kernel (csrc/dec_self_wide.cu) at the others up to
    WIDE_MAX_C, the split route above (post_plan: three launches; qin: a
    bf16 [R, 2C] buffer whose columns C.. hold qpos, which qpos may be a
    view of; made here and qpos copied in when None)."""
    r, c = att.shape
    plan = post_plan(r, c, ENC_CHUNK)
    if plan.get("split"):
        if qin is None:
            qin = torch.empty((r, 2 * c), dtype=torch.bfloat16,
                              device=att.device)
        if qin[:, c:].data_ptr() != qpos.data_ptr():
            qin[:, c:].copy_(qpos)
        x1 = gemm(att, w["wso"], b_nk=True, slabs=True, bias=w["bso"],
                  pre=xb, out_dtype=torch.float32)
        layernorm(x1, w["g1"], w["be1"], eps, out_f32=x1,
                  out_bf16=qin[:, :c])
        return x1, gemm(qin, w["wcq"], b_nk=True, slabs=True, bias=w["bcq"])
    cp, c2p = plan.get("c_pad", c), plan.get("c2_pad", 2 * c)
    ptrs = [_operand(att, (r, c)), _operand(xb, (r, c)),
            _operand(qpos, (r, c)), _operand(w["wso"], (cp, cp))] + \
        _vectors(w, "bso", "g1", "be1") + [
            _operand(w["wcq_x"], (c2p, cp)),
            _operand(w["wcq_p"], (c2p, cp))] + _vectors(w, "bcq")
    x1 = torch.empty((r, c), dtype=torch.float32, device=att.device)
    q2 = torch.empty((r, 2 * c), dtype=torch.bfloat16, device=att.device)
    if plan.get("wide"):
        _call("ec_dec_post_self_wide", *ptrs, x1.data_ptr(), q2.data_ptr(),
              r, c, cp, c2p, float(eps), _stream())
        launches["dec_post_self_wide_kernel"] += 1
        return x1, q2
    _call("ec_dec_post_self", *ptrs, x1.data_ptr(), q2.data_ptr(), r,
          float(eps), _stream())
    launches["dec_post_self_kernel"] += 1
    return x1, q2


def gcn_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """The adjacency [B, 2, K, K] as the split route's GCN products take
    it: bf16, its rows at a stride of K rounded up to 8 (a tensor map
    needs 16-byte row strides; the columns past K are never read), returned as the [B, 2, K, K] view of that buffer; adj
    itself where it already is one."""
    b, _, k, _ = adj.shape
    k8 = _up(k, 8)
    if adj.dtype == torch.bfloat16 and adj.stride() == (
            2 * k * k8, k * k8, k8, 1) and adj.data_ptr() % 16 == 0:
        return adj
    buf = torch.empty((b, 2, k, k8), dtype=torch.bfloat16, device=adj.device)
    view = buf[..., :k]
    view.copy_(adj)
    return view


def _dec_post_cross_split(att2, x1, adj, w, *, eps, out_dtype, out):
    """dec_post_cross above WIDE_MAX_C channels as its plain version's
    steps (eight launches): o2 = bf16(att2 . wco^T + bco), x2
    = LN2(o2 . wch^T + bch + x1), y = bf16(bf16(x2) . wg^T + bg), per
    batch row m = adj0 . y0 (fp32) then bf16(relu(adj1 . y1 + m)), out =
    LN3(relu(m) . wf^T + bf + x2)."""
    b, k, c2 = att2.shape
    c, r, f = c2 // 2, b * k, w["wf"].shape[1]
    f32 = torch.float32
    a = gcn_adjacency(adj)
    mm = functools.partial(gemm, b_nk=True, slabs=True)
    o2 = mm(att2.view(r, c2), w["wco"], bias=w["bco"])
    x2 = mm(o2, w["wch"], bias=w["bch"], pre=x1, out_dtype=f32)
    del o2
    _, x2b = layernorm(x2, w["g2"], w["be2"], eps, out_f32=x2, out_bf16=True)
    y = mm(x2b, w["wg"], bias=w["bg"]).view(b, k, 2 * f)
    del x2b
    m = mm(a[:, 0], y[..., :f], b_nk=False, out_dtype=f32)
    m = mm(a[:, 1], y[..., f:], b_nk=False, pre=m, act=ACT_RELU)
    del y
    o3 = mm(m.view(r, f), w["wf"], bias=w["bf"], pre=x2, out_dtype=f32)
    if out is None:
        out = torch.empty((r, c), dtype=out_dtype, device=att2.device)
    elif out.dtype != out_dtype or tuple(out.shape) != (r, c):
        raise ValueError(f"dec_post_cross out {out.dtype} "
                         f"{tuple(out.shape)} is not {out_dtype} {(r, c)}")
    if out_dtype == f32:
        layernorm(o3, w["g3"], w["be3"], eps, out_f32=out)
    else:
        layernorm(o3, w["g3"], w["be3"], eps, out_f32=False, out_bf16=out)
    return out


def dec_post_cross(att2: torch.Tensor, x1: torch.Tensor, adj: torch.Tensor,
                   w: dict, *, eps: float, out_dtype,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The decoder layer after its cross-attention: o2 = bf16(att2 . wco^T
    + bco), x2 = LN2(x1 + o2 . wch^T + bch), y_s = bf16(bf16(x2) . wg_s^T
    + bg_s) and per batch row m = adj0 . y0 + adj1 . y1, then out = LN3(x2
    + bf16(relu(m)) . wf^T + bf). att2: contiguous bf16 [B, K, 2C]; x1:
    fp32 [B K, C]; adj: [B, 2, K, K] fp32 or bf16 (rounded to bf16 in
    the kernel). Returns [B K, C] in out_dtype. At POST_C channels and up
    to POST_TILE keypoints one launch of dec_post_cross_kernel, a batch
    row a tile, y formed per F chunk; at the others two launches
    (csrc/dec_wide.cu): dec_post_cross_wide_kernel over the flattened rows
    (x2 and y into scratch buffers), then dec_post_gcn_wide_kernel over
    tiles of one batch row, its GCN weights in the wide layout (w["wg"]
    [2 f_pad, c_pad], w["wf"] [c_pad, f_pad] of post_plan's wide plan:
    ops/fused_decoder.py cross_weights). Above WIDE_MAX_C channels the
    split route's eight launches, the adjacency laid out by
    gcn_adjacency (given so, it is read as it is), the output written into
    `out` where given (a contiguous [B K, C] tensor of out_dtype)."""
    b, k, c2 = att2.shape
    c = c2 // 2
    f = w["wf"].shape[1]
    plan = post_plan(b * k, c, f, chunk=DEC_CHUNK, keypoints=k)
    if plan.get("split"):
        _cuda(adj)
        if tuple(adj.shape) != (b, 2, k, k):
            raise ValueError(f"adjacency {tuple(adj.shape)} is not "
                             f"{(b, 2, k, k)}")
        return _dec_post_cross_split(att2, x1, adj, w, eps=eps,
                                     out_dtype=out_dtype, out=out)
    if out is not None:
        raise ValueError("dec_post_cross writes into `out` on the split "
                         "route only")
    if adj.dtype not in (torch.float32, torch.bfloat16):
        adj = adj.to(torch.float32)
    adj = adj.contiguous()
    if plan.get("wide"):
        return _dec_post_cross_wide(att2, x1, adj, w, plan, eps=eps,
                                    out_dtype=out_dtype)
    ptrs = [_operand(att2, (b, k, c2)), _operand(w["wco"], (c2, c2))] + \
        _vectors(w, "bco") + [_operand(w["wch"], (c, c2))] + \
        _vectors(w, "bch") + [_operand(x1, (b * k, c), torch.float32)] + \
        _vectors(w, "g2", "be2") + [_operand(w["wg"], (2 * f, c))] + \
        _vectors(w, "bg")
    _cuda(adj)
    if tuple(adj.shape) != (b, 2, k, k):
        raise ValueError(f"adjacency {tuple(adj.shape)} is not "
                         f"{(b, 2, k, k)}")
    out = torch.empty((b * k, c), dtype=out_dtype, device=att2.device)
    _call("ec_dec_post_cross", *ptrs, adj.data_ptr(), _dt(adj),
          _operand(w["wf"], (c, f)), *_vectors(w, "bf", "g3", "be3"),
          out.data_ptr(), _dt(out), b, k, f, float(eps), _stream())
    launches["dec_post_cross_kernel"] += 1
    return out


def _dec_post_cross_wide(att2, x1, adj, w, plan, *, eps, out_dtype):
    b, k, c2 = att2.shape
    c = c2 // 2
    cp, c2p, fp = plan["c_pad"], plan["c2_pad"], plan["f_pad"]
    _cuda(adj)
    if tuple(adj.shape) != (b, 2, k, k):
        raise ValueError(f"adjacency {tuple(adj.shape)} is not "
                         f"{(b, 2, k, k)}")
    ptrs = [_operand(att2, (b, k, c2)), _operand(w["wco"], (c2p, c2p))] + \
        _vectors(w, "bco") + [_operand(w["wch"], (cp, c2p))] + \
        _vectors(w, "bch") + [_operand(x1, (b * k, c), torch.float32)] + \
        _vectors(w, "g2", "be2") + [_operand(w["wg"], (2 * fp, cp))] + \
        _vectors(w, "bg")
    x2 = torch.empty((b * k, c), dtype=torch.float32, device=att2.device)
    y = torch.empty((b * k, 2 * fp), dtype=torch.bfloat16, device=att2.device)
    out = torch.empty((b * k, c), dtype=out_dtype, device=att2.device)
    _call("ec_dec_post_cross_wide", *ptrs, adj.data_ptr(), _dt(adj),
          _operand(w["wf"], (cp, fp)), *_vectors(w, "bf", "g3", "be3"),
          x2.data_ptr(), y.data_ptr(), out.data_ptr(), _dt(out), b, k, c, cp,
          c2p, fp, float(eps), _stream())
    launches["dec_post_cross_wide_kernel"] += 1
    launches["dec_post_gcn_wide_kernel"] += 1
    return out


# The ViT MLP half (csrc/kernels.cu vit_mlp_kernel): rows of VIT_C
# channels in tiles of VIT_TILE rows, the hidden in chunks of VIT_CHUNK
# columns that never leave the SM.
VIT_C, VIT_TILE, VIT_CHUNK = 384, 128, 64


def vit_mlp_plan(rows: int, c: int, f: int) -> dict:
    """How the ViT MLP half covers `rows` rows of c channels with a hidden
    of width f. At VIT_C channels vit_mlp_kernel: `tiles` of VIT_TILE rows
    (a persistent grid of at most one block an SM walks them), whose
    `pad_rows` missing rows (the last tile's) the prologue fills with zeros
    and the epilogue does not store, and `chunks` of VIT_CHUNK hidden
    columns. At any other width the wide route (vit_mlp_wide):
    vit_ln_gemm_kernel (LN2, fc1, bias and GELU; its plan `fc1`), then the
    GEMM (fc2, its bias and the LayerScale residual); the plan holds
    `wide`: True. Raises for what the kernels do not take: a hidden width
    that is not a positive multiple of VIT_CHUNK, no rows, a width
    vit_ln_gemm_plan refuses."""
    if f <= 0 or f % VIT_CHUNK:
        raise ValueError(f"hidden width {f} is not a positive multiple of "
                         f"{VIT_CHUNK}")
    if rows <= 0:
        raise ValueError(f"no rows ({rows})")
    if c != VIT_C:
        return {"wide": True, "fc1": vit_ln_gemm_plan(rows, c, f)}
    tiles = -(-rows // VIT_TILE)
    return {"tiles": tiles, "pad_rows": tiles * VIT_TILE - rows,
            "chunks": f // VIT_CHUNK}


def vit_mlp(x: torch.Tensor, w: dict, *, eps: float, out_dtype,
            next_ln=None):
    """The ViT block's MLP half, one launch: y = x + ls * (bf16(gelu(
    bf16(LN(x)) . W1 + b1)) . W2 + b2), the hidden kept on chip. x:
    contiguous fp32 or bf16 [R, 384]; w: g, be (the LayerNorm), w1, b1, w2,
    b2, ls and `kmajor`: w1 [F, 384] and w2 [384, F] bf16 (torch Linear
    weights) when true, else w1 [384, F] and w2 [F, 384] (as the JAX
    function takes them). With next_ln = (gamma, beta) also the next
    block's h = bf16(LN'(bf16(y))) in layernorm's summation order. Returns
    (y [R, 384] in out_dtype, h bf16 [R, 384] or None)."""
    _cuda(x)
    r, c = x.shape
    f = w["b1"].numel()
    if vit_mlp_plan(r, c, f).get("wide"):
        raise ValueError(f"the ViT MLP kernel takes {VIT_C} channels, got {c} "
                         f"(vit_mlp_wide takes the others)")
    shapes = ((f, c), (c, f)) if w["kmajor"] else ((c, f), (f, c))
    ptrs = [_operand(x, (r, c), x.dtype), _dt(x)] + _vectors(w, "g", "be") + [
        _operand(w["w1"], shapes[0])] + _vectors(w, "b1") + [
        _operand(w["w2"], shapes[1])] + _vectors(w, "b2", "ls")
    out = torch.empty((r, c), dtype=out_dtype, device=x.device)
    hn, nxt = None, [None, None]
    if next_ln is not None:
        nxt = [_operand(v, (c,), torch.float32) for v in next_ln]
        hn = torch.empty((r, c), dtype=torch.bfloat16, device=x.device)
    _call("ec_vit_mlp", *ptrs, int(bool(w["kmajor"])), out.data_ptr(),
          _dt(out), *nxt, _ptr(hn), r, f, float(eps), _stream())
    launches["vit_mlp_kernel"] += 1
    return out, hn


# The ViT attention half (csrc/kernels.cu vit_qkv_kernel, vit_attn_kernel):
# VIT_HEADS heads of VIT_D channels; a score row holds VIT_KEYS keys in
# registers (two wgmma m64n136 halves); vit_attn_kernel takes items of
# VIT_TILE query rows of one image, a warpgroup 64 of them, in
# VIT_ATTN_SMEM bytes of shared memory (two att tiles of 64 x 384 bf16, K
# and V of a head, three 16 KB weight slots, barriers, bp and ls).
VIT_HEADS, VIT_D, VIT_KEYS = 6, 64, 272
VIT_ATTN_SMEM = 1024 + 2 * VIT_HEADS * 8192 + 2 * VIT_KEYS * 128 + 3 * 16384 \
    + 128 + 8 * VIT_C


def vit_attn_plan(b: int, n: int, c: int, heads: int) -> dict:
    """How the kernels of the ViT attention half cover B images of N tokens
    of c channels: vit_qkv_kernel's `qkv_tiles` of VIT_TILE rows (a
    persistent grid of at most one block an SM walks them; it works row by
    row, whatever N); vit_attn_kernel's `items`, `items_per_image` of
    VIT_TILE query rows each, of which `query_tiles` 64-row tiles an image
    hold real rows (a warpgroup whose 64 rows all lie past N multiplies
    nothing) and `pad_rows` rows an image are padding; every score row
    spans `key_pad` keys (those past N masked) and a block holds
    `smem_bytes` of shared memory.

    Above VIT_KEYS tokens, which vit_attn_kernel's score row does not
    hold, the half after vit_qkv_kernel is attn_long_kernel on the q, k
    and v columns of its output, then the GEMM with the projection's bias
    and the LayerScale residual in its epilogue: the plan holds `long`:
    True, `qkv_tiles` and the attention's plan as `attention`. Raises for
    what the kernels do not take: no image or token.

    Any other width whose heads are at most 128 channels takes the wide
    route (vit_attn_wide): vit_ln_gemm_kernel (LN1 and the q | k | v
    projection), `attention` on the q, k and v columns of its output
    (attn_kernel, or attn_long_kernel above ATT_MAX_KEYS tokens), then the
    GEMM with the projection's bias and the LayerScale residual in its
    epilogue: the plan holds `wide`: True, `qkv` (vit_ln_gemm_plan's) and
    `attention` (attention_plan's). Raises for channels that do not split
    into the heads, a head dim above 128, a width vit_ln_gemm_plan refuses
    and a token count the attention kernels do not take at the head dim."""
    if b < 1 or n < 1:
        raise ValueError(f"the ViT attention kernels take an image and a "
                         f"token, got B={b}, N={n}")
    if (c, heads) != (VIT_C, VIT_HEADS):
        if heads < 1 or c % heads:
            raise ValueError(f"{c} channels do not split into {heads} heads")
        d = c // heads
        if d > ATT_HEAD_DIMS[-1]:
            raise ValueError(f"the ViT kernels take head dims up to "
                             f"{ATT_HEAD_DIMS[-1]}, got {d} ({c} channels in "
                             f"{heads} heads)")
        return {"wide": True, "qkv": vit_ln_gemm_plan(b * n, c, 3 * c),
                "attention": attention_plan(n, n, d)}
    qkv_tiles = -(-(b * n) // VIT_TILE)
    if n > VIT_KEYS:
        return {"qkv_tiles": qkv_tiles, "long": True,
                "attention": attention_plan(n, n, VIT_D, long=True)}
    per_image = -(-n // VIT_TILE)
    return {"qkv_tiles": qkv_tiles, "items": b * per_image,
            "items_per_image": per_image, "query_tiles": -(-n // 64),
            "pad_rows": per_image * VIT_TILE - n, "key_pad": VIT_KEYS,
            "smem_bytes": VIT_ATTN_SMEM}


def vit_qkv(x: torch.Tensor, w: dict, *, eps: float) -> torch.Tensor:
    """The ViT block's LN1 and q | k | v projection, one launch:
    bf16(bf16(LN(bf16(x))) . Wqkv^T + bqkv), h kept on chip. x: contiguous
    fp32 or bf16 [R, 384]; w: n1w, n1b (LN1), wqkv bf16 [1152, 384] (torch
    Linear layout) and bqkv fp32 [1152]. Returns qkv bf16 [R, 1152]."""
    _cuda(x)
    if x.dim() != 2 or x.shape[1] != VIT_C:
        raise ValueError(f"vit_qkv takes [R, {VIT_C}] rows, got "
                         f"{tuple(x.shape)}")
    r, c = x.shape
    ptrs = [_operand(x, (r, c), x.dtype), _dt(x)] + _vectors(
        w, "n1w", "n1b") + [_operand(w["wqkv"], (3 * c, c))] + _vectors(
        w, "bqkv")
    out = torch.empty((r, 3 * c), dtype=torch.bfloat16, device=x.device)
    _call("ec_vit_qkv", *ptrs, out.data_ptr(), r, float(eps), _stream())
    launches["vit_qkv_kernel"] += 1
    return out


def vit_attn(qkv: torch.Tensor, x: torch.Tensor, w: dict, *,
             out_dtype) -> torch.Tensor:
    """The rest of the ViT block's attention half: y = bf16(x) + ls1 *
    (att . Wp^T + bp), att = bf16(bf16(softmax(q k^T / 8)) v) per head
    over all keys of a row. qkv: contiguous bf16 [B, N, 1152] (vit_qkv's);
    x: contiguous fp32 or bf16 [B, N, 384] (the residual); w: wp bf16
    [384, 384] (torch Linear layout), bp and ls1 fp32. Returns [B, N, 384]
    in out_dtype. One launch of vit_attn_kernel, att kept on chip; where
    vit_attn_plan is long (above VIT_KEYS tokens), attn_long_kernel writes
    att and the GEMM adds the projection and the residual."""
    _cuda(qkv, x)
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"vit_attn takes qkv [B, N, 3 C], got "
                         f"{tuple(qkv.shape)}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    plan = vit_attn_plan(b, n, c, VIT_HEADS)
    if plan.get("wide"):
        raise ValueError(f"the ViT attention kernels take {VIT_HEADS} heads "
                         f"of {VIT_D} ({VIT_C} channels), got {c} channels "
                         f"(vit_attn_wide takes the others)")
    ptrs = [_operand(qkv, (b, n, c3)), _operand(x, (b, n, c), x.dtype),
            _dt(x), _operand(w["wp"], (c, c))] + _vectors(w, "bp", "ls1")
    if plan.get("long"):
        att = attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                        num_heads=VIT_HEADS, scale=VIT_D ** -0.5,
                        plan=plan["attention"])
        res = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
        return gemm(att.view(b * n, c), w["wp"], b_nk=True,
                    out_dtype=out_dtype, bias=w["bp"],
                    res=res.view(b * n, c), ls=w["ls1"]).view(b, n, c)
    out = torch.empty((b, n, c), dtype=out_dtype, device=qkv.device)
    _call("ec_vit_attn", *ptrs, out.data_ptr(), _dt(out), b, n,
          float(VIT_D ** -0.5), plan["smem_bytes"], _stream())
    launches["vit_attn_kernel"] += 1
    return out


# The ViT block at every other trunk width (csrc/vit_wide.cu
# vit_ln_gemm_kernel, LayerNorm + projection): the grid first normalises
# every row once into h, a bf16 scratch copy of x that the wrapper
# allocates, then multiplies tiles of VIT_WIDE_TILE rows by the output
# columns in groups of VIT_WIDE_GROUP, h and W streamed by TMA through a
# ring of VIT_WIDE_STAGES stages of VIT_WIDE_STAGE bytes ([128 rows x 64
# k] of h and [256 columns x 64 k] of W), as many as fit in VIT_WIDE_SMEM
# beside the bias. C is a multiple of 64 up to VIT_WIDE_MAX_C (a warp
# holds four rows of 1024 channels in registers for the LayerNorm). A CTA
# has VIT_WIDE_THREADS threads: two consumer warpgroups and a producer
# warpgroup whose one warp issues the loads.
VIT_WIDE_TILE, VIT_WIDE_GROUP, VIT_WIDE_MAX_C = 128, 256, 1024
VIT_WIDE_STAGE = 128 * 64 * 2 + 256 * 64 * 2
VIT_WIDE_SMEM, VIT_WIDE_STAGES, VIT_WIDE_THREADS = 232448, 4, 384
# output columns whose bias the epilogue reads from shared memory
VIT_WIDE_BIAS = 8192
# the CTAs an H100 SXM runs at once (one an SM), where no card is asked
VIT_WIDE_SMS = 132


def _vit_wide_parts(tiles: int, groups: int, ctas: int) -> int:
    """The column parts (1..groups) that finish first: rounds of the
    ctas over tiles x parts units of ceil(groups / parts) groups each; the
    fewest parts on a tie."""
    def cost(parts):
        return -(-tiles * parts // ctas) * -(-groups // parts)
    return min(range(1, groups + 1), key=lambda parts: (cost(parts), parts))


def vit_ln_gemm_plan(rows: int, c: int, n: int, *,
                     ctas: Optional[int] = None) -> dict:
    """How vit_ln_gemm_kernel covers `rows` rows of c channels with n
    output columns: `tiles` of VIT_WIDE_TILE rows (`pad_rows` of the last
    are zeros and not stored), `k_slabs` of 64 channels, `groups` of
    VIT_WIDE_GROUP output columns (the last may be partly past n), a ring
    of `stages` (a tile's [128 x 64] of its normalised rows and a group's
    [256 x 64] of W), `smem_bytes` of shared memory (the ring, the bias
    of up to VIT_WIDE_BIAS columns, barriers) a CTA of `threads`
    (`producer_warps` issuing loads, `consumer_warpgroups` of 64 rows each).
    `column_split` parts of a tile's groups (at most `groups_per_unit`
    each) make `units`, which a persistent grid of `ctas` CTAs walks (the
    card's count where the wrapper plans, else VIT_WIDE_SMS). The split is
    the one whose last round ends first. Raises for what the kernel does
    not take: c not a multiple of 64 in 64..VIT_WIDE_MAX_C, n not a
    positive multiple of 64, no rows."""
    if c % 64 or not 64 <= c <= VIT_WIDE_MAX_C:
        raise ValueError(f"the wide ViT kernel takes 64..{VIT_WIDE_MAX_C} "
                         f"channels in steps of 64, got {c}")
    if n <= 0 or n % 64:
        raise ValueError(f"the wide ViT kernel takes output widths in steps "
                         f"of 64, got {n}")
    if rows <= 0:
        raise ValueError(f"no rows ({rows})")
    ctas = ctas or VIT_WIDE_SMS
    tiles = -(-rows // VIT_WIDE_TILE)
    groups = -(-n // VIT_WIDE_GROUP)
    parts = _vit_wide_parts(tiles, groups, ctas)
    return {"tiles": tiles, "pad_rows": tiles * VIT_WIDE_TILE - rows,
            "k_slabs": c // 64, "groups": groups, "stages": VIT_WIDE_STAGES,
            "ctas": ctas, "column_split": parts,
            "groups_per_unit": -(-groups // parts), "units": tiles * parts,
            "threads": VIT_WIDE_THREADS, "producer_warps": 1,
            "consumer_warpgroups": 2,
            "smem_bytes": 1024 + VIT_WIDE_STAGES * (VIT_WIDE_STAGE + 16)
            + 4 * VIT_WIDE_BIAS}


@functools.lru_cache(maxsize=None)
def vit_ln_gemm_ctas() -> int:
    """The CTAs of vit_ln_gemm_kernel the card runs at once (occupancy
    times the SMs)."""
    n = ctypes.c_int(0)
    _call("ec_vit_ln_gemm_ctas", ctypes.addressof(n))
    return n.value


def vit_ln_gemm_card_plan(rows: int, c: int, n: int) -> dict:
    """vit_ln_gemm_plan with the card's own count of CTAs: the plan a
    launch of vit_ln_gemm takes."""
    return vit_ln_gemm_plan(rows, c, n, ctas=vit_ln_gemm_ctas())


def vit_ln_gemm(x: torch.Tensor, g, be, w: torch.Tensor, bias, *,
                eps: float, b_nk: bool = True, gelu: bool = False,
                round_in: bool = False,
                column_split: Optional[int] = None) -> torch.Tensor:
    """bf16(act(bf16(LN(x)) . W + bias)), one launch of
    vit_ln_gemm_kernel: LayerNorm with fp32 statistics (of bf16(x) with
    round_in), act GELU (gelu) or none. x: contiguous fp32 or bf16 [R, C];
    g, be [C] and bias [N] vectors; W bf16, [N, C] (b_nk, torch Linear
    layout) or [C, N]. column_split: the parts of a tile's groups (the
    plan's unless given: measurements of other splits, 1..the groups). The
    kernel's scratch, bf16(LN(x)) [R, C] and the grid barrier's counter,
    is allocated here. Returns bf16 [R, N]."""
    _cuda(x, w)
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"vit_ln_gemm takes x [R, C] and a matrix W, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    r, c = x.shape
    n = w.shape[0] if b_nk else w.shape[1]
    if (w.shape[1] if b_nk else w.shape[0]) != c:
        raise ValueError(f"vit_ln_gemm: W {tuple(w.shape)} does not take "
                         f"{c} channels (b_nk={b_nk})")
    plan = vit_ln_gemm_card_plan(r, c, n)              # refusals, by name
    parts = plan["column_split"] if column_split is None else column_split
    if not 1 <= parts <= plan["groups"]:
        raise ValueError(f"vit_ln_gemm: a column split of {parts}, not "
                         f"1..{plan['groups']}")
    vec = {"g": _f32(g), "be": _f32(be), "bias": _f32(bias)}
    if vec["g"].numel() != c or vec["be"].numel() != c \
            or vec["bias"].numel() != n:
        raise ValueError("vit_ln_gemm: LayerNorm or bias widths differ")
    ptrs = [_operand(x, (r, c), x.dtype), _dt(x), int(bool(round_in))] + \
        _vectors(vec, "g", "be") + [_operand(w, tuple(w.shape)), int(b_nk)] \
        + _vectors(vec, "bias")
    # h [R, C], then 16 bytes for the counter of the kernel's grid barrier
    h = torch.empty(r * c + 8, dtype=torch.bfloat16, device=x.device)
    out = torch.empty((r, n), dtype=torch.bfloat16, device=x.device)
    _call("ec_vit_ln_gemm", *ptrs, ACT_GELU if gelu else ACT_NONE,
          h.data_ptr(), out.data_ptr(), r, c, n, float(eps),
          plan["smem_bytes"], parts, _stream())
    launches["vit_ln_gemm_kernel"] += 1
    return out


def vit_attn_wide(x: torch.Tensor, w: dict, *, num_heads: int, eps: float,
                  out_dtype) -> torch.Tensor:
    """The ViT block's attention half on the wide route (vit_attn_plan's
    `wide`): y = bf16(x) + ls1 * (att . Wp^T + bp), att the attention over
    qkv = vit_ln_gemm(x, LN1, Wqkv, round_in) per head. x: contiguous fp32
    or bf16 [B, N, C]; w: n1w, n1b, wqkv bf16 [3 C, C], bqkv, wp bf16
    [C, C] (torch Linear layouts), bp, ls1. Three launches: vit_ln_gemm,
    attention (on the q, k, v column views of qkv), the GEMM. Returns
    [B, N, C] in out_dtype."""
    b, n, c = x.shape
    qkv = vit_ln_gemm(x.view(b * n, c), w["n1w"], w["n1b"], w["wqkv"],
                      w["bqkv"], eps=eps, round_in=True).view(b, n, 3 * c)
    att = attention(qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:],
                    num_heads=num_heads, scale=(c // num_heads) ** -0.5)
    res = x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
    return gemm(att.reshape(b * n, c), w["wp"], b_nk=True,
                out_dtype=out_dtype, bias=w["bp"], res=res.view(b * n, c),
                ls=w["ls1"]).view(b, n, c)


def vit_mlp_wide(x: torch.Tensor, w: dict, *, eps: float,
                 out_dtype) -> torch.Tensor:
    """The ViT block's MLP half on the wide route (vit_mlp_plan's `wide`):
    y = x + ls * (f . W2 + b2), f = vit_ln_gemm(x, LN, W1, b1, GELU), the
    hidden stored as bf16. x: contiguous fp32 or bf16 [R, C] (the residual
    as given); w as vit_mlp takes it (g, be, w1, b1, w2, b2, ls, kmajor).
    Two launches: vit_ln_gemm and the GEMM. Returns [R, C] in out_dtype."""
    kmajor = bool(w["kmajor"])
    f = vit_ln_gemm(x, w["g"], w["be"], w["w1"], w["b1"], eps=eps,
                    b_nk=kmajor, gelu=True)
    return gemm(f, w["w2"], b_nk=kmajor, out_dtype=out_dtype, bias=w["b2"],
                res=x, ls=w["ls"])


# The decoder stack's own kernels (csrc/kernels.cu bias_attn_kernel,
# kpt_head_kernel): the self-attention with the Markov bias formed once for
# all BA_HEADS heads of head dim BA_D, its hop planes and hidden units at
# most BA_HOP_MAX and BA_HID_MAX; the keypoint head.
BA_HEADS, BA_D, BA_HOP_MAX, BA_HID_MAX = 8, 32, 8, 32
BA_MLP_BYTES = (2 * BA_HID_MAX * 8 + BA_HID_MAX + BA_HEADS) * 4
# blocks a call should have at least: two rounds of an H100's 132 SMs at
# one block an SM; fewer batch rows split their query tiles over blocks
BA_MIN_BLOCKS = 264


# bias_attn_wide_kernel (csrc/head_wide.cu) at every other head count and
# head dim: up to BA_WIDE_HEADS heads of up to ATT_HEAD_DIMS[-1] (run at
# attention_head_dim), BA_WIDE_WARPS warps a block taking the heads of a
# pass; the MLP's tables in shared memory hold BA_WIDE_MLP_FLOATS.
BA_WIDE_HEADS, BA_WIDE_WARPS = 16, 8
BA_WIDE_MLP_FLOATS = BA_HID_MAX * (8 + BA_WIDE_HEADS + 1) + BA_WIDE_HEADS


def bias_wide_smem(heads: int, nkp: int, dp: int, per_pass: int,
                   resident: bool) -> int:
    """Shared memory of bias_attn_wide_kernel (head_wide.cu bw_smem):
    per_pass head slots (bf16 rows of dp + 8: resident, K and V [nkp]
    each, else K, then V over it, [nkp]; and a query tile [16]), the bias
    of a tile for every head [heads, 16, nkp] fp32, the key mask and the
    MLP."""
    slot = ((2 if resident else 1) * nkp + 16) * (dp + 8) * 2
    return per_pass * slot + 4 * heads * 16 * nkp + 4 * nkp \
        + 4 * BA_WIDE_MLP_FLOATS


def _q_split(b, tiles):
    """Blocks a batch row of how many 16-query tiles each, so that a call
    has BA_MIN_BLOCKS blocks where its tiles allow."""
    q_split = min(tiles, -(-BA_MIN_BLOCKS // b))
    per_block = -(-tiles // q_split)
    return -(-tiles // per_block), per_block


# bias_attn_long_kernel (csrc/bias_long.cu) above BA_RESIDENT_KEYS keys:
# BA_WIDE_WARPS warps a block, a warp one head of a 16-query tile (two
# above BA_WIDE_WARPS heads); BA_SM_SMEM bytes of shared memory an SM, 1 KB
# of them reserved a block.
BA_RESIDENT_KEYS, BA_SM_SMEM = ATT_ROW16 * 16, 233472


def bias_long_key_tile(dp: int, heads: int) -> int:
    """Keys of bias_attn_long_kernel's streamed tile (bias_long.cu
    bl_key_tile): 64, or 32 / 16 where 16 heads of head dim 64 / 128 leave
    no room."""
    if heads <= BA_WIDE_WARPS or dp == 32:
        return 64
    return 32 if dp == 64 else 16


def bias_long_smem(heads: int, dp: int, key_tile: int) -> int:
    """Shared memory of bias_attn_long_kernel (bias_long.cu bl_smem): the
    tile's queries [heads, 16, dp + 8] bf16, a key or value tile [heads,
    key_tile, dp + 8] bf16, the tile's bias [heads, 16, key_tile] fp32, its
    key mask and the MLP."""
    return 32 * heads * (dp + 8) + 2 * heads * key_tile * (dp + 8) \
        + 64 * heads * key_tile + 4 * key_tile + 4 * BA_WIDE_MLP_FLOATS


def _bias_long_plan(b, n, heads, d):
    dp = attention_head_dim(d)
    kt = bias_long_key_tile(dp, heads)
    smem = bias_long_smem(heads, dp, kt)
    two = heads <= BA_WIDE_WARPS and dp <= 64     # bl_min_blocks
    per_sm = max(1, min(2 if two else 1, BA_SM_SMEM // (smem + 1024)))
    qtiles = -(-n // 16)
    return (("long", True), ("d_pad", dp),
            ("heads_per_warp", -(-heads // BA_WIDE_WARPS)),
            ("key_tile", kt), ("query_tiles", qtiles),
            ("key_tiles", -(-n // kt)), ("items", b * qtiles),
            ("blocks_per_sm", per_sm), ("smem_bytes", smem),
            ("scratch_floats", heads * 16 * qtiles * 16))


@functools.lru_cache(maxsize=None)
def _bias_attention_plan(b, n, heads, d):
    if not (1 <= heads <= BA_WIDE_HEADS and 1 <= d <= ATT_HEAD_DIMS[-1]):
        raise ValueError(f"the bias attention takes 1..{BA_WIDE_HEADS} heads "
                         f"of 1..{ATT_HEAD_DIMS[-1]}, got {heads} of {d}")
    if b < 1 or n < 1:
        raise ValueError(f"the bias attention takes keypoints and a batch, "
                         f"got B={b}, K={n}")
    if n > BA_RESIDENT_KEYS:
        return _bias_long_plan(b, n, heads, d)
    tiles = -(-n // 16)
    if (heads, d) != (BA_HEADS, BA_D):
        dp, nkp = attention_head_dim(d), tiles * 16

        def fits(per_pass, resident):
            return bias_wide_smem(heads, nkp, dp, per_pass,
                                  resident) <= ATT_SMEM_LIMIT
        resident = fits(heads, True)
        if resident:                    # K, V of every head once a block
            per_pass = heads
            q_split, per_block = _q_split(b, tiles)
        else:                           # passes of heads, a tile a block
            per_pass = max(g for g in range(1, min(heads, BA_WIDE_WARPS) + 1)
                           if fits(g, False))
            per_pass = -(-heads // -(-heads // per_pass))
            q_split, per_block = tiles, 1
        return (("wide", True), ("q_split", q_split),
                ("tiles_per_block", per_block), ("key_tiles", tiles),
                ("d_pad", dp), ("resident", resident),
                ("heads_per_pass", per_pass),
                ("passes", -(-heads // per_pass)),
                ("smem_bytes", bias_wide_smem(heads, nkp, dp, per_pass,
                                              resident)))
    q_split, per_block = _q_split(b, tiles)
    nkp, ld = tiles * 16, heads * d + 8
    smem = 2 * nkp * ld * 2 + 16 * ld * 2 + heads * 16 * nkp * 4 + nkp * 4 \
        + BA_MLP_BYTES
    if smem > ATT_SMEM_LIMIT:
        raise ValueError(f"bias attention plan does not fit: {smem} bytes")
    return (("q_split", q_split), ("tiles_per_block", per_block),
            ("key_tiles", tiles), ("smem_bytes", smem))


def bias_attention_plan(b: int, n: int, heads: int, d: int) -> dict:
    """The launch plan of the bias attention for B batch rows of N
    keypoints, from the shapes alone: block (row, y) of the q_split blocks
    of a batch row takes the 16-query tiles [y * tiles_per_block,
    (y + 1) * tiles_per_block); key_tiles 16-key tiles hold the row;
    smem_bytes: keys and values [key_tiles * 16, 264] bf16, a query tile,
    the bias of a tile [heads, 16, key_tiles * 16] fp32, the key mask and
    the MLP's weights. That is bias_attn_kernel's, for 8 heads of 32; at
    any other head count and dim the plan holds `wide`: True and
    bias_attn_wide_kernel's: the head dim run at `d_pad`; `resident`
    where every head's K, V and queries fit beside the bias (one pass, a
    block taking tiles_per_block tiles with K and V loaded once), else one
    tile a block and the heads in `passes` of `heads_per_pass` (at most
    BA_WIDE_WARPS, a warp a head), each head's V copied over its K after
    the scores; smem_bytes: the slots, the bias of a tile for every head
    [heads, 16, key_tiles * 16] fp32, the key mask and the MLP
    (bias_wide_smem). Above BA_RESIDENT_KEYS keypoints, at every head count
    and dim, the plan holds `long`: True and bias_attn_long_kernel's: the
    head dim run at `d_pad`, `heads_per_warp`, the keys streamed in
    `key_tiles` tiles of `key_tile`, `items` 16-query tiles (`query_tiles`
    a batch row) walked by a persistent grid of `blocks_per_sm` blocks an
    SM, `smem_bytes` (bias_long_smem) and each block's scratch of
    `scratch_floats` finished scores. Raises for what the kernels do not
    take: more than 16 heads, head dims above 128, no keypoints."""
    return dict(_bias_attention_plan(int(b), int(n), int(heads), int(d)))


def bias_attention(qkv: torch.Tensor, key_valid, hops: torch.Tensor,
                   hop_mlp, *, num_heads: int) -> torch.Tensor:
    """The decoder's self-attention with its Markov bias, one launch:
    softmax(q k^T / sqrt(d) + key mask + bias) v per head, with bias[h, i,
    j] = relu(hops[b, i, j] . w1 + b1) . w2[:, h] + b2[h] formed in the
    kernel once for all heads. qkv: contiguous bf16 [B, K, 3 C] (q | k |
    v); key_valid: bool [B, K] or None; hops: contiguous bf16 [B, K, K,
    n_hop] (the hop stack's own layout); hop_mlp: fp32 (w1 [n_hop, hid],
    b1 [hid], w2 [hid, H], b2 [H]). Returns bf16 [B, K, C].
    bias_attn_kernel, bias_attn_wide_kernel or, above BA_RESIDENT_KEYS
    keypoints, bias_attn_long_kernel (bias_attention_plan), which writes
    each block's finished scores to a scratch buffer made here."""
    w1, b1, w2, b2 = hop_mlp
    _cuda(qkv, key_valid, hops, w1, b1, w2, b2)
    b, n, c3 = qkv.shape
    c = c3 // 3
    plan = bias_attention_plan(b, n, num_heads, c // num_heads)
    nhop, hid = w1.shape
    if not (1 <= nhop <= BA_HOP_MAX and 1 <= hid <= BA_HID_MAX):
        raise ValueError(f"the bias MLP takes 1..{BA_HOP_MAX} hop planes and "
                         f"1..{BA_HID_MAX} hidden units, got {nhop}, {hid}")
    ptrs = [_operand(qkv, (b, n, c3)), _operand(hops, (b, n, n, nhop),
                                                align=2)]
    ptrs += [_operand(t, shape, torch.float32, 4) for t, shape in (
        (w1, (nhop, hid)), (b1, (hid,)), (w2, (hid, num_heads)),
        (b2, (num_heads,)))]
    key_valid, kv_ptr, kv_stride = _key_mask(key_valid, b, n)
    out = torch.empty((b, n, c), dtype=torch.bfloat16, device=qkv.device)
    if plan.get("long"):
        grid = min(plan["items"], plan["blocks_per_sm"] * _sms(qkv.device))
        scores = torch.empty((grid, plan["scratch_floats"]),
                             dtype=torch.float32, device=qkv.device)
        d = c // num_heads
        _call("ec_bias_attention_long", ptrs[0], b, n, num_heads, d, kv_ptr,
              kv_stride, ptrs[1], nhop, hid, *ptrs[2:], float(d ** -0.5),
              out.data_ptr(), scores.data_ptr(), grid, plan["key_tile"],
              plan["smem_bytes"], _stream())
        launches["bias_attn_long_kernel"] += 1
        return out
    if plan.get("wide"):
        d = c // num_heads
        _call("ec_bias_attention_wide", ptrs[0], b, n, num_heads, d, kv_ptr,
              kv_stride, ptrs[1], nhop, hid, *ptrs[2:], float(d ** -0.5),
              out.data_ptr(), plan["q_split"], plan["tiles_per_block"],
              plan["heads_per_pass"], int(plan["resident"]),
              plan["smem_bytes"], _stream())
        launches["bias_attn_wide_kernel"] += 1
        return out
    _call("ec_bias_attention", ptrs[0], b, n, kv_ptr, kv_stride, ptrs[1],
          nhop, hid, *ptrs[2:], float((c // num_heads) ** -0.5),
          out.data_ptr(), plan["q_split"], plan["tiles_per_block"],
          plan["smem_bytes"], _stream())
    launches["bias_attn_kernel"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def kpt_coord(h: torch.Tensor, ct: torch.Tensor, kow, kob,
              pts: torch.Tensor, outs: torch.Tensor) -> None:
    """The keypoint head's delta and coordinate update on the split route,
    one launch of kpt_coord_kernel (csrc/kpt_coord.cu): for the stacked
    rows h = [h(x); h(LN(x))] bf16 [2R, C] (the last kpt_branch layer's
    output), dd = h . kow^T + kob, pts = sigmoid(inverse_sigmoid(ct) + dd
    of rows 0..R-1), outs = the same of rows R..2R-1, the log-odds clipped
    at 1e-3, written in place. kow bf16 [2, C], kob fp32 [2]; ct, pts,
    outs contiguous fp32 [R, 2]."""
    r2, c = h.shape
    r = r2 // 2
    if r2 != 2 * r or r < 1:
        raise ValueError(f"kpt_coord takes 2 R stacked rows, got {r2}")
    ptrs = [_operand(h, (r2, c), align=4), _operand(kow, (2, c), align=4),
            _operand(kob, (2,), torch.float32, 4)]
    ptrs += [_operand(t, (r, 2), torch.float32, 4) for t in (ct, pts, outs)]
    _call("ec_kpt_coord", *ptrs, r, c, 1e-3, _stream())
    launches["kpt_coord_kernel"] += 1


def _kpt_head_split(x, ct, fn, kpt, kow, kob, pts, outs, *, eps, kin):
    r, c = x.shape
    if kin is None:
        kin = torch.empty((2 * r, c), dtype=torch.bfloat16, device=x.device)
    elif kin.dtype != torch.bfloat16 or tuple(kin.shape) != (2 * r, c) \
            or not kin.is_contiguous():
        raise ValueError(f"kpt_head kin {kin.dtype} {tuple(kin.shape)} is "
                         f"not a contiguous bfloat16 {(2 * r, c)}")
    if kin.data_ptr() != x.data_ptr():
        kin[:r].copy_(x)
    layernorm(kin[:r], fn[0], fn[1], eps, out_f32=False, out_bf16=kin[r:])
    h = kin
    for w, bb in kpt:
        h = gemm(h, w, b_nk=True, slabs=True, bias=bb, act=ACT_GELU)
    kpt_coord(h, ct, kow, kob, pts, outs)


def kpt_head(x: torch.Tensor, ct: torch.Tensor, fn, kpt, kow, kob,
             pts: torch.Tensor, outs: torch.Tensor, *, eps: float,
             kin: Optional[torch.Tensor] = None) -> None:
    """A decoder layer's keypoint head, one launch: with n = LN(x) (fn =
    (gamma, beta)), h = bf16(gelu(h . w_i^T + b_i)) for (w_i, b_i) in kpt
    from h = x and from h = n, dd = h . kow^T + kob, and pts =
    sigmoid(inverse_sigmoid(ct) + dd of x), outs = the same of n (the
    log-odds clipped at 1e-3, pos_enc.inverse_sigmoid's), written in
    place. x: contiguous bf16 [R, C]; kpt: three (bf16 [C, C], fp32
    [C]); kow bf16 [2, C], kob fp32 [2]; ct, pts, outs: contiguous fp32
    [R, 2]. kpt_head_kernel at POST_C channels; at any other C up to
    WIDE_MAX_C (kpt_head_plan) kpt_head_wide_kernel, whose kpt weights are
    [c_pad, c_pad] with zero padding (pad_cols); above, the split route
    (kpt_head_plan: the final norm into the second half of kin, a bf16
    [2R, C] buffer whose first half holds x (x may be that view; made here
    and x copied in when None), the three layers as GEMMs with the GELU
    epilogue, kpt_coord)."""
    r, c = x.shape
    plan = kpt_head_plan(r, c)
    if plan.get("split"):
        _kpt_head_split(x, ct, fn, kpt, kow, kob, pts, outs, eps=eps,
                        kin=kin)
        return
    if plan.get("wide"):
        cp = plan["c_pad"]
        ptrs = [_operand(x, (r, c))] + [
            _operand(v, (c,), torch.float32) for v in fn]
        for w, bb in kpt:
            ptrs += [_operand(w, (cp, cp), align=32),
                     _operand(bb, (c,), torch.float32)]
        ptrs += [_operand(kow, (2, c)), _operand(kob, (2,), torch.float32)]
        ptrs += [_operand(t, (r, 2), torch.float32, a)
                 for t, a in ((ct, 8), (pts, 4), (outs, 4))]
        _call("ec_kpt_head_wide", *ptrs, r, c, cp, float(eps), 1e-3,
              _stream())
        launches["kpt_head_wide_kernel"] += 1
        return
    ptrs = [_operand(x, (r, POST_C))] + [
        _operand(v, (POST_C,), torch.float32) for v in fn]
    for w, bb in kpt:
        ptrs += [_operand(w, (POST_C, POST_C)),
                 _operand(bb, (POST_C,), torch.float32)]
    ptrs += [_operand(kow, (2, POST_C)), _operand(kob, (2,), torch.float32)]
    ptrs += [_operand(t, (r, 2), torch.float32, 4) for t in (ct, pts, outs)]
    _call("ec_kpt_head", *ptrs, r, float(eps), 1e-3, _stream())
    launches["kpt_head_kernel"] += 1


# kpt_head_wide_kernel (csrc/kpt_wide.cu): a consumer warpgroup's
# KPT_WIDE_TILE accumulator rows are 32 source rows as they are and the
# same rows normed; up to POST_C channels each warpgroup holds all c_pad
# (c rounded up to 64) channels of its own 32 rows, above it the two split
# c_pad = 2 enc_wide_half(c) channels of the same 32; the weights in
# WIDE_BOX units through rings of at most KPT_WIDE_SLOTS slots (one both
# warpgroups take, or one each).
KPT_WIDE_TILE, KPT_WIDE_SLOTS = 64, 16


def kpt_wide_layout(c: int) -> dict:
    """kpt_head_wide_kernel's instance at c channels (csrc/kpt_wide.cu
    kw_smem): `c_pad`, `half` (the channels a warpgroup holds), `split`
    (the warpgroups split the channels), `rings`, `slots` a ring and
    `smem_bytes`: alignment slack, two sets of A boxes [64, c_pad] bf16
    (a warpgroup's own, or shared), the rings of WIDE_BOX slots, dd's
    partial sums, two tiles' coordinates in for each warpgroup, the seven
    vectors (three biases, the final norm's two, Wo's two rows) in fp32
    [c_pad], two barriers a slot."""
    split = c > POST_C
    half = enc_wide_half(c) if split else _up(c, 64)
    c_pad = 2 * half if split else half
    rings = 2 if split else 1
    fixed = 1024 + (2 if split else 4) * (c_pad // 64) * WIDE_BOX \
        + 4 * 2 * 2 * KPT_WIDE_TILE + 2 * 2 * 32 * 8 + 7 * 4 * c_pad
    slots = min(KPT_WIDE_SLOTS,
                (ATT_SMEM_LIMIT - fixed) // (rings * (WIDE_BOX + 16)))
    return {"c_pad": c_pad, "half": half, "split": split, "rings": rings,
            "slots": slots,
            "smem_bytes": fixed + rings * slots * (WIDE_BOX + 16)}


@functools.lru_cache(maxsize=None)
def kpt_wide_card_layout(c: int) -> dict:
    """kpt_wide_layout as the built kernel takes it: what csrc/kpt_wide.cu
    ec_kpt_wide_layout computes at c channels."""
    out = (ctypes.c_int * 5)()
    _call("ec_kpt_wide_layout", c, ctypes.addressof(out))
    return {"c_pad": out[0], "half": out[1], "split": out[0] != out[1],
            "rings": out[2], "slots": out[3], "smem_bytes": out[4]}


def kpt_head_plan(rows: int, c: int) -> dict:
    """How the keypoint head covers `rows` rows of c channels:
    kpt_head_kernel's tiles of 64 rows at POST_C channels, else (`wide`:
    True) kpt_head_wide_kernel's (kpt_wide_layout, with the kpt weights
    padded to `c_pad`): `instance` "rows" up to 255 channels (a tile of
    `source_rows` 64, 32 a warpgroup, `tile_rows` 128 stacked: every weight
    box serves both warpgroups' rows as they are and normed), "channels"
    above 256 (the warpgroups split the channels over one tile of 32
    source rows, 64 stacked); `tiles`, `slots` a ring of `rings`,
    `smem_bytes`. Above WIDE_MAX_C channels the split route (`split`:
    True: the final norm, the three kpt_branch GEMMs with the GELU
    epilogue, kpt_coord_kernel; the weights not padded), at channels in
    multiples of 8 (split_refusal). Raises for no channels, no rows or a
    split width split_refusal names."""
    if c < 1:
        raise ValueError(f"the keypoint head takes 1 channel or more, got "
                         f"{c}")
    if rows <= 0:
        raise ValueError(f"no rows ({rows})")
    if c > WIDE_MAX_C:
        why = split_refusal(c)
        if why:
            raise ValueError(why)
        return {"split": True}
    if c == POST_C:
        return {"tiles": -(-rows // 64)}
    lay = kpt_wide_layout(c)
    src = KPT_WIDE_TILE // 2 if lay["split"] else KPT_WIDE_TILE
    return {"wide": True, "c_pad": lay["c_pad"], "half": lay["half"],
            "instance": "channels" if lay["split"] else "rows",
            "tile_rows": 2 * src, "source_rows": src,
            "tiles": -(-rows // src), "rings": lay["rings"],
            "slots": lay["slots"], "smem_bytes": lay["smem_bytes"]}


# The matmul chain of the probe tool (csrc/mm_chain.cu mm_chain_kernel):
# tiles of MM_TILE rows cut inside segments, one block each; w1 / w2 in
# chunks of MM_CHUNK hidden columns through a ring of 16 KB slots beside
# the resident x tile, as many as fit a block's shared memory (at most 12).
MM_TILE, MM_CHUNK, MM_SLOT, MM_SMEM_LIMIT = 128, 64, 16384, 232448


def mm_chain_plan(segs: int, seg_rows: int, c: int, f: int) -> dict:
    """How mm_chain_kernel covers `segs` segments of `seg_rows` rows of c
    channels with a hidden of width f: `tiles` of MM_TILE rows (one block
    each, `tiles_per_seg` a segment), of whose rows `useful_rows` hold data
    (the rest the TMA fills with zeros and the stores skip); `chunks` of
    MM_CHUNK hidden columns, each c / 128 slots of w1 then c / 128 of w2;
    `stages` ring slots beside the x tile; `smem_bytes` a block. Raises for
    what the kernel does not take: C not 128, 256 or 384, F not a positive
    multiple of 64, no rows, more blocks than a grid holds."""
    if c not in (128, 256, 384):
        raise ValueError(f"mm_chain takes C in (128, 256, 384), got C={c}")
    if f <= 0 or f % MM_CHUNK:
        raise ValueError(f"mm_chain takes F a positive multiple of "
                         f"{MM_CHUNK}, got F={f}")
    if segs <= 0 or seg_rows <= 0:
        raise ValueError(f"mm_chain: no rows ({segs} segments of "
                         f"{seg_rows})")
    per_seg = -(-seg_rows // MM_TILE)
    tiles = segs * per_seg
    if tiles > 2 ** 31 - 1:
        raise ValueError(f"mm_chain: {tiles} tiles exceed a grid")
    nt = c // 64
    stages = min(12, (MM_SMEM_LIMIT - 1024 - nt * MM_SLOT - 64)
                 // (MM_SLOT + 12))
    smem = 1024 + (nt + stages) * MM_SLOT + 8 + ((stages * 12 + 7) & ~7)
    return {"tiles": tiles, "tiles_per_seg": per_seg,
            "useful_rows": segs * seg_rows,
            "pad_rows": tiles * MM_TILE - segs * seg_rows,
            "useful_share": segs * seg_rows / (tiles * MM_TILE),
            "chunks": f // MM_CHUNK, "slots_per_chunk": 2 * (c // 128),
            "stages": stages, "smem_bytes": smem}


def mm_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, reps: int,
             segs: int, seg_rows: int) -> torch.Tensor:
    """The whole chain of `reps` steps x = bf16(f32(x) + bf16(x @ w1) @ w2)
    in one launch. x: contiguous bf16 [segs * seg_rows, C] (any leading
    shape); row tiles are cut inside each segment of `seg_rows` rows.
    w1 [C, F], w2 [F, C] contiguous bf16 (mm_chain_plan says which C and F
    the kernel takes); every operand starts on 16 bytes."""
    _cuda(x, w1, w2)
    c, f = w1.shape
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           for t in (x, w1, w2)):
        raise TypeError("mm_chain takes contiguous bfloat16 tensors")
    if x.shape[-1] != c or tuple(w2.shape) != (f, c) \
            or x.numel() != segs * seg_rows * c:
        raise ValueError(f"mm_chain shapes: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
                         f"{segs} segments of {seg_rows} rows")
    mm_chain_plan(segs, seg_rows, c, f)
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("mm_chain operands must start on 16 bytes")
    if reps < 0:
        raise ValueError(f"mm_chain takes reps >= 0, got {reps}")
    out = torch.empty_like(x)
    _call("ec_mm_chain", x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
          out.data_ptr(), segs, seg_rows, c, f, int(reps), _stream())
    return out


def launch_counts() -> dict:
    """Launches of every hand-written kernel so far, by the kernel's name
    as a profiler trace shows it (a substring of it), from the wrappers'
    counters: exact, but blind to PyTorch's own kernels (copies, casts)
    that a trace also shows."""
    from . import mm_chain as _mm
    return dict(launches, mm_chain_kernel=_mm.launches)


def _why(*plans) -> Optional[str]:
    """None when every plan accepts its shapes, else the first refusal."""
    try:
        for plan in plans:
            plan()
    except ValueError as e:
        return str(e)
    return None


def width_misfits(cfg, vit_dim: Optional[int] = None,
                  vit_heads: int = VIT_HEADS, patch: int = 14,
                  vit_hidden: Optional[int] = None) -> dict:
    """For each fused op of a model: None when its hand-written kernels take
    the model's widths, else why not (the refusal of the plan that would
    raise at launch). cfg: a ModelConfig (d_model, nhead, dim_feedforward,
    max_kpt, image_size, attn_bias, backbone_dim); the ViT trunk is
    vit_dim channels (backbone_dim by default) in vit_heads heads over
    patch-size patches, with an MLP hidden of vit_hidden (4 x the width by
    default). Pure Python, from the shapes the plans see at run time:

    * fused_vit_block (and fused_vit_block2; also #9 and #10's halves):
      384 channels in 6 heads on the resident kernels (any token count:
      above VIT_KEYS the attention streams its keys), any other width of
      64..VIT_WIDE_MAX_C channels in steps of 64 in heads of up to 128 on
      the wide route (vit_ln_gemm_kernel, attention, GEMM) at the token
      counts the attention takes at its head dim; an MLP hidden in steps
      of 64;
    * flash_mha (ViT / encoder / keypoints): head dims 1..128 (run at 32,
      64 or 128) at the trunk's tokens, the joint encoder's image +
      keypoint tokens, the keypoint tokens (the skeleton's and the
      decoder's self-attention), eval and training; any key count (above
      what a resident block holds, ATT_MAX_KEYS or at head dim 128 416
      keys, the streaming kernels);
    * fused_encoder_stack: up to WIDE_MAX_C channels the post-attention
      kernels (any channel count and hidden width), above it the split
      route (channels and hidden in multiples of 8, split_refusal), and
      the encoder's attention;
    * fused_decoder_layer: the same channels, any keypoint count (above
      POST_TILE the cross layer's wide pair up to WIDE_MAX_C channels),
      the self- and the cross-attention (head dim 2 C / H);
    * fused_decoder_stack: the layer's, the bias attention's 1..16 heads
      of 1..128 (with the Markov bias; above 128 keypoints streamed,
      bias_attn_long_kernel) and the keypoint head's channels (the
      split route's above WIDE_MAX_C).
    What stays refused, by the plan that refuses it: a trunk above
    VIT_WIDE_MAX_C channels or not in steps of 64, head dims above 128
    (1024 channels in 8 heads: a cross-attention head dim of 256), more
    than 16 heads with the Markov bias (1088 in 17), and above WIDE_MAX_C
    channels or a hidden that is no multiple of 8 (580 in 10: the slab
    GEMM's tensor maps need 16-byte row strides). No keypoint count or
    image size is refused."""
    c, h, f = int(cfg.d_model), int(cfg.nhead), int(cfg.dim_feedforward)
    k = int(cfg.max_kpt)
    vc = int(cfg.backbone_dim if vit_dim is None else vit_dim)
    hw = (int(cfg.image_size) // patch) ** 2
    tokens = hw + 1
    d, d2 = c // h, 2 * c // h
    vit_hidden = 4 * vc if vit_hidden is None else vit_hidden

    def heads(width, n_heads):
        def check():
            if width % n_heads:
                raise ValueError(f"{width} channels do not split into "
                                 f"{n_heads} heads")
        return check

    def att(nq, nk, hd):
        return lambda: (attention_plan(nq, nk, hd),
                        attention_plan(nq, nk, hd, train=True))

    enc_att = att(hw + k, hw + k, d)
    layer = (heads(c, h), lambda: post_plan(1, c, ENC_CHUNK),
             lambda: post_plan(k, c, f, chunk=DEC_CHUNK, keypoints=k),
             att(k, k, d), att(k, hw, d2))
    stack = layer + ((lambda: bias_attention_plan(1, k, h, d),)
                     if cfg.attn_bias else ()) + (
                         lambda: kpt_head_plan(k, c),)
    return {
        "fused_vit_block": _why(
            lambda: vit_attn_plan(1, tokens, vc, vit_heads),
            lambda: vit_mlp_plan(1, vc, vit_hidden)),
        "flash_mha (ViT)": _why(heads(vc, vit_heads),
                                att(tokens, tokens, vc // vit_heads)),
        "flash_mha (encoder)": _why(heads(c, h), enc_att),
        "flash_mha (keypoints)": _why(heads(c, h), att(k, k, d)),
        "fused_encoder_stack": _why(heads(c, h),
                                    lambda: post_plan(1, c, f), enc_att),
        "fused_decoder_layer": _why(*layer),
        "fused_decoder_stack": _why(*stack),
    }
