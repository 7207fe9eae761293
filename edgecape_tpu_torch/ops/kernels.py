"""Build, load and call the hand-written CUDA kernels (`csrc/*.cu`):
in `kernels.cu` the building blocks of the eval ops, the glue kernels of
the decoder stack and the training attention's forward / backward pair,
in `mm_chain.cu` the matmul chain of the probe tool.

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
import glob
import hashlib
import os
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

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_F = ctypes.c_float
_U32 = ctypes.c_uint
# q, k, v, dtype, six strides, B, H, D, Nq, Nk, key bias + stride, bias,
# scale, seed (device pointer), keep threshold, 1 / (1 - rate)
_TRAIN_HEAD = [_P, _P, _P, _I, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _I,
               _P, _L, _P, _F, _P, _U32, _F]
_SIGNATURES = {
    "ec_gemm": [_P, _L, _L, _P, _L, _L, _I, _P, _L, _L, _I, _I, _I, _I, _I,
                _P, _P, _I, _L, _L, _I, _P, _I, _L, _L, _P, _P],
    "ec_layernorm": [_P, _I, _L, _P, _I, _L, _P, _P, _F, _P, _L, _P, _L,
                     _I, _I, _P],
    "ec_add_pos": [_P, _I, _P, _P, _L, _L, _P],
    "ec_attention": [_P, _P, _P, _I, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I,
                     _I, _P, _L, _P, _F, _P, _I, _L, _L, _P, _I, _I, _P, _P,
                     _P, _P, _P],
    "ec_sine_feats": [_P, _P, _P, _L, _I, _P],
    "ec_coord_update": [_P, _P, _P, _P, _L, _F, _P],
    "ec_attn_train_fwd": _TRAIN_HEAD + [_P, _L, _L, _P, _P],
    "ec_attn_train_bwd": _TRAIN_HEAD + [_P, _I, _L, _L, _P, _P, _P, _P, _P,
                                        _P],
    "ec_dropout_mask": [_P, _U32, _L, _I, _I, _P, _P],
    "ec_mm_chain": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
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


def library_path(src: str) -> str:
    """The library of one source, named by a hash of it and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(os.path.basename(src).encode() + b"\0" + f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(),
                        f"libedgecape_{stem}_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> list:
    """Compile every source whose library is missing, one `nvcc` per
    source, all started together; returns the libraries' paths."""
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
        cmd = [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
            + ["-o", tmp, src]
        procs.append((path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(out)
            continue
        if verbose:
            print(out)
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


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


def gemm(a: torch.Tensor, b: torch.Tensor, *, b_nk: bool,
         out_dtype=torch.bfloat16, bias=None, pre=None, act: int = ACT_NONE,
         res=None, ls=None, out=None) -> torch.Tensor:
    """out = epilogue(a @ (b^T if b_nk else b)).

    a: [M, K] or batched [Z, M, K] bf16 with unit last stride. b: [N, K]
    (b_nk, a torch Linear weight) or [K, N], optionally batched [Z, ...]
    (an unbatched operand is shared across the batch). pre / res:
    [M, N] or [Z, M, N] fp32 or bf16 (a 2-D one is shared across the
    batch). Epilogue: y = acc + bias + pre; act; y = res + ls * y.
    `out`: a tensor of the result's shape to write into (its dtype is the
    output dtype), for callers that keep their activation buffers."""
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
    _call("ec_gemm", pa, lda, sa, pb, ldb, sb, int(b_nk), pc, ldc, sc,
          _dt(out), m, n, k, z, _ptr(bias), pp,
          _dt(pre) if pre is not None else 0, ldp, sp, act, pr,
          _dt(res) if res is not None else 0, ldr, sr, _ptr(ls), _stream())
    return out


def _ln_out(want, x, dtype):
    """An output of layernorm: None, a new tensor, or the caller's own
    (contiguous, x's shape, `dtype`)."""
    if want is False or want is None:
        return None
    if want is True:
        return torch.empty(x.shape, dtype=dtype, device=x.device)
    if want.dtype != dtype or want.shape != x.shape \
            or not want.is_contiguous() or not want.is_cuda:
        raise ValueError("layernorm output buffer does not fit")
    return want


def layernorm(x: torch.Tensor, gamma, beta, eps: float, *, r=None,
              out_f32=True, out_bf16=False):
    """LN(x + r) over the last dim with fp32 statistics; returns
    (fp32 or None, bf16 or None). out_f32 / out_bf16: False, True (a new
    tensor) or a tensor to write into."""
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
          beta.data_ptr(), float(eps), _ptr(of), c, _ptr(ob), c, rows, c,
          _stream())
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
    return out


def attention(q, k, v, *, num_heads: int, scale: float, key_bias=None,
              bias=None, hops=None, hop_mlp=None, out_dtype=torch.bfloat16,
              out=None) -> torch.Tensor:
    """Multi-head attention on [B, N, H*D] views (unit last stride):
    softmax(q k^T * scale + key_bias[b] + bias[b, h]) v per head, output
    [B, Nq, H*D] rounded to bf16 (stored as out_dtype, or into `out`).
    key_bias: [B, Nk] fp32 (0 or -inf); bias: [B, H, Nq, Nk] fp32. In its
    place, `hops` [B, n_hop, Nq, Nk] bf16 with hop_mlp = (w1 [n_hop, hid],
    b1 [hid], w2 [hid, H], b2 [H]) fp32 has the kernel form the Markov bias
    relu(hops . w1 + b1) . w2 + b2 itself, so that it never lies in device
    memory (head dim 32 only)."""
    _cuda(q, k, v, key_bias, bias, hops, out)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ")
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("attention operands need a unit last stride")
    if key_bias is not None:
        key_bias = key_bias.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        if tuple(bias.shape) != (b, num_heads, nq, nk):
            raise ValueError(f"bias shape {tuple(bias.shape)}")
    nhop = hid = 0
    w1 = b1 = w2 = b2 = None
    if hops is not None:
        w1, b1, w2, b2 = hop_mlp
        _cuda(w1, b1, w2, b2)
        nhop, hid = w1.shape
        if bias is not None or hops.dtype != torch.bfloat16 \
                or not hops.is_contiguous() \
                or tuple(hops.shape) != (b, nhop, nq, nk) \
                or tuple(w2.shape) != (hid, num_heads) \
                or any(t.dtype != torch.float32 or not t.is_contiguous()
                       for t in (w1, b1, w2, b2)):
            raise ValueError("in-kernel Markov bias takes a contiguous bf16 "
                             "hop stack [B, n_hop, Nq, Nk], fp32 MLP weights "
                             "and no other bias")
    if out is None:
        out = torch.empty((b, nq, c), dtype=out_dtype, device=q.device)
    elif tuple(out.shape) != (b, nq, c) or out.stride(-1) != 1:
        raise ValueError(f"attention out {tuple(out.shape)}")
    _call("ec_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), _dt(q),
          q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
          v.stride(1), b, num_heads, d, nq, nk, _ptr(key_bias),
          key_bias.stride(0) if key_bias is not None else 0, _ptr(bias),
          float(scale), out.data_ptr(), _dt(out), out.stride(0),
          out.stride(1), _ptr(hops), nhop, hid, _ptr(w1), _ptr(b1),
          _ptr(w2), _ptr(b2), _stream())
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
    return out


def coord_update(ct: torch.Tensor, dd: torch.Tensor, pts: torch.Tensor,
                 outs: torch.Tensor, eps: float = 1e-3) -> None:
    """pts = sigmoid(inverse_sigmoid(ct) + dd[:R]), outs = sigmoid(
    inverse_sigmoid(ct) + dd[R:]) for ct [R, 2] and dd [2R, 2], all fp32
    and contiguous; pts and outs [R, 2] are written in place."""
    _cuda(ct, dd, pts, outs)
    n = ct.numel()
    for t, size in ((ct, n), (dd, 2 * n), (pts, n), (outs, n)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != size:
            raise ValueError("coord_update takes contiguous fp32 tensors "
                             "[R, 2], [2R, 2], [R, 2], [R, 2]")
    _call("ec_coord_update", ct.data_ptr(), dd.data_ptr(), pts.data_ptr(),
          outs.data_ptr(), n, float(eps), _stream())


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


def _train_head(q, k, v, num_heads, scale, key_bias, bias, seed, rate):
    """Checks and the leading arguments shared by the two training
    attention entry points; returns (args, key_bias, bias) with the
    fp32 contiguous tensors kept alive by the caller."""
    _cuda(q, k, v, key_bias, bias)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v dtypes differ")
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    if d not in (32, 64) or max(nq, nk) > 512:
        raise ValueError(f"training attention takes head dim 32 or 64 and at "
                         f"most 512 tokens, got D={d}, Nq={nq}, Nk={nk}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("attention operands need a unit last stride")
    if key_bias is not None:
        key_bias = key_bias.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        if tuple(bias.shape) != (b, num_heads, nq, nk):
            raise ValueError(f"bias shape {tuple(bias.shape)}")
    thresh, inv_keep = dropout_threshold(rate)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), _dt(q), q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            b, num_heads, d, nq, nk, _ptr(key_bias),
            key_bias.stride(0) if key_bias is not None else 0, _ptr(bias),
            float(scale), _seed_ptr(seed, thresh), thresh, inv_keep]
    return args, key_bias, bias


def attention_train_fwd(q, k, v, *, num_heads: int, scale: float,
                        key_bias=None, bias=None, seed=None,
                        rate: float = 0.0):
    """Training attention forward on [B, N, H*D] views: returns
    (out fp32 [B, Nq, H*D], stats fp32 [B*H, Nq, 2] = row max and
    reciprocal exp-sum, for the backward). Dropout at `rate` on the
    probabilities from Philox keyed by `seed`, a one-element int64 CUDA
    tensor."""
    args, key_bias, bias = _train_head(q, k, v, num_heads, scale, key_bias,
                                       bias, seed, rate)
    b, nq, c = q.shape
    out = torch.empty((b, nq, c), dtype=torch.float32, device=q.device)
    stats = torch.empty((b * num_heads, nq, 2), dtype=torch.float32,
                        device=q.device)
    _call("ec_attn_train_fwd", *args, out.data_ptr(), out.stride(0),
          out.stride(1), stats.data_ptr(), _stream())
    return out, stats


def attention_train_bwd(q, k, v, dout, stats, *, num_heads: int,
                        scale: float, key_bias=None, bias=None,
                        seed=None, rate: float = 0.0,
                        need_dbias: bool = True):
    """Training attention backward: (dq, dk, dv fp32 [B, N, H*D], dbias
    fp32 [B, H, Nq, Nk] or None when there is no bias or it is not
    needed), with the dropout mask regenerated from `seed`."""
    args, key_bias, bias = _train_head(q, k, v, num_heads, scale, key_bias,
                                       bias, seed, rate)
    _cuda(dout, stats)
    b, nq, c = q.shape
    nk = k.shape[1]
    dout = dout.contiguous()
    if tuple(dout.shape) != (b, nq, c):
        raise ValueError(f"dout shape {tuple(dout.shape)}")
    dq = torch.empty((b, nq, c), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, nk, c), dtype=torch.float32, device=q.device)
    dv = torch.empty((b, nk, c), dtype=torch.float32, device=q.device)
    dbias = None if bias is None or not need_dbias else torch.empty(
        (b, num_heads, nq, nk), dtype=torch.float32, device=q.device)
    _call("ec_attn_train_bwd", *args, dout.data_ptr(), _dt(dout),
          dout.stride(0), dout.stride(1), stats.data_ptr(), dq.data_ptr(),
          dk.data_ptr(), dv.data_ptr(), _ptr(dbias), _stream())
    return dq, dk, dv, dbias


def dropout_mask(seed: torch.Tensor, rate: float, bh: int, nq: int,
                 nk: int) -> torch.Tensor:
    """The keep mask the training attention kernels draw for (seed, rate):
    bool [bh, nq, nk] on the seed's device."""
    thresh, _ = dropout_threshold(rate)
    keep = torch.empty((bh, nq, nk), dtype=torch.uint8, device=seed.device)
    _call("ec_dropout_mask", _seed_ptr(seed, thresh), thresh, bh, nq, nk,
          keep.data_ptr(), _stream())
    return keep.bool()


def mm_chain(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, reps: int,
             segs: int, seg_rows: int) -> torch.Tensor:
    """The whole chain of `reps` steps x = bf16(f32(x) + bf16(x @ w1) @ w2)
    in one launch. x: contiguous bf16 [segs * seg_rows, C] (any leading
    shape); row tiles are cut inside each segment of `seg_rows` rows.
    w1 [C, F], w2 [F, C] contiguous bf16, C in (128, 256, 384), F a
    multiple of 64."""
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
    if c not in (128, 256, 384) or f % 64 != 0:
        raise ValueError(f"mm_chain takes C in (128, 256, 384) and F a "
                         f"multiple of 64, got C={c}, F={f}")
    out = torch.empty_like(x)
    _call("ec_mm_chain", x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
          out.data_ptr(), segs, seg_rows, c, f, int(reps), _stream())
    return out
