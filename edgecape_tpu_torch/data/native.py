"""ctypes binding of the host preprocessing core (`csrc/preprocess.cc`);
counterpart of edgecape_tpu/data/native.py.

Multithreaded batch affine warp (normalized float32, or uint8 for the eval
path) and gaussian heatmap rendering on the host. The library is built at
first use with the host C++ compiler into `edgecape_tpu_torch/_build/` (or
`$EDGECAPE_TORCH_BUILD_DIR`), named by a hash of the source, so an edited
source rebuilds. A build that fails raises: the loader has no slower
Python path to fall back to, and every machine computes the same pixels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "preprocess.cc")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LIB_LOCK = threading.Lock()
_LIB = None


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set $CXX, or put g++ on "
                       "PATH): the data loader's preprocessing core "
                       f"({SOURCE}) is built at first use")


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    base = os.environ.get("EDGECAPE_TORCH_BUILD_DIR",
                          os.path.join(_PKG, "_build"))
    return os.path.join(base,
                        f"libedgecape_preprocess_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the source if its library is missing; returns the path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    proc = subprocess.run([_cxx()] + CXX_FLAGS + ["-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("building the preprocessing core failed:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            ip = ctypes.POINTER(ctypes.c_int)
            fp = ctypes.POINTER(ctypes.c_float)
            i = ctypes.c_int
            so.warp_normalize_batch.argtypes = [u8p, i64p, ip, ip, fp, fp, i,
                                                i, i, fp, fp, i]
            so.warp_uint8_batch.argtypes = [u8p, i64p, ip, ip, fp, u8p, i, i,
                                            i, i]
            heatmap_sig = [fp, fp, fp, fp, i, i, i, i, ctypes.c_float,
                           ctypes.c_float, ctypes.c_float, i]
            so.msra_heatmaps_batch.argtypes = heatmap_sig
            so.udp_heatmaps_batch.argtypes = heatmap_sig
            for fn in (so.warp_normalize_batch, so.warp_uint8_batch,
                       so.msra_heatmaps_batch, so.udp_heatmaps_batch):
                fn.restype = None
            _LIB = so
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _threads(num_threads: int, n: int) -> int:
    return num_threads if num_threads > 0 else min(os.cpu_count() or 1, n)


def _warp_args(images, inv_mats):
    """The flattened sources and per-image tables both warps take."""
    n = len(images)
    flat = np.ascontiguousarray(
        np.concatenate([im.reshape(-1) for im in images]).astype(
            np.uint8, copy=False))
    sizes = np.array([im.size for im in images], np.int64)
    offsets = np.zeros(n, np.int64)
    offsets[1:] = np.cumsum(sizes)[:-1]
    hs = np.array([im.shape[0] for im in images], np.int32)
    ws = np.array([im.shape[1] for im in images], np.int32)
    mats = np.ascontiguousarray(inv_mats, np.float32)
    ip = ctypes.POINTER(ctypes.c_int)
    return (flat, offsets, hs, ws, mats), (
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        hs.ctypes.data_as(ip), ws.ctypes.data_as(ip), _fptr(mats))


def warp_normalize_batch(images: list, inv_mats: np.ndarray, out_hw: tuple,
                         mean, std, num_threads: int = 0) -> np.ndarray:
    """images: list of [H_i, W_i, 3] uint8 RGB; inv_mats [n, 2, 3];
    returns [n, h, w, 3] float32 normalized."""
    n = len(images)
    h, w = out_hw
    keep, args = _warp_args(images, inv_mats)
    out = np.empty((n, h, w, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib().warp_normalize_batch(*args, _fptr(out), n, h, w, _fptr(mean),
                               _fptr(std), _threads(num_threads, n))
    return out


def warp_uint8_batch(images: list, inv_mats: np.ndarray, out_hw: tuple,
                     num_threads: int = 0) -> np.ndarray:
    """As warp_normalize_batch without the normalization: [n, h, w, 3]
    uint8, rounded to nearest."""
    n = len(images)
    h, w = out_hw
    keep, args = _warp_args(images, inv_mats)
    out = np.empty((n, h, w, 3), np.uint8)
    lib().warp_uint8_batch(
        *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
        _threads(num_threads, n))
    return out


def _heatmaps(name, joints, visible, heatmap_hw, image_hw, sigma,
              num_threads):
    joints = np.ascontiguousarray(joints, np.float32)
    visible = np.ascontiguousarray(visible, np.float32)
    n, k = joints.shape[:2]
    hh, hw = heatmap_hw
    target = np.empty((n, k, hh, hw), np.float32)
    weight = np.empty((n, k), np.float32)
    getattr(lib(), name)(
        _fptr(joints), _fptr(visible), _fptr(target), _fptr(weight),
        n, k, hh, hw, float(image_hw[0]), float(image_hw[1]), float(sigma),
        _threads(num_threads, n))
    return target, weight


def msra_heatmaps_batch(joints: np.ndarray, visible: np.ndarray,
                        heatmap_hw: tuple, image_hw: tuple, sigma: float,
                        num_threads: int = 0):
    """joints [n, k, 2], visible [n, k] -> (target [n, k, H, W],
    weight [n, k])."""
    return _heatmaps("msra_heatmaps_batch", joints, visible, heatmap_hw,
                     image_hw, sigma, num_threads)


def udp_heatmaps_batch(joints: np.ndarray, visible: np.ndarray,
                       heatmap_hw: tuple, image_hw: tuple, sigma: float,
                       num_threads: int = 0):
    """UDP variant of msra_heatmaps_batch: continuous sub-pixel gaussian
    center, stride (img-1)/(hm-1), as ops/heatmap.render_udp_np."""
    return _heatmaps("udp_heatmaps_batch", joints, visible, heatmap_hw,
                     image_hw, sigma, num_threads)
