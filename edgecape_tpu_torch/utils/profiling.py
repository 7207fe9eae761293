"""Profiling and timing utilities; counterpart of
edgecape_tpu/utils/profiling.py.

`trace(log_dir)`: a torch.profiler trace of the enclosed block (host
ops, and the card's kernels and copies when a card is in use), written
into log_dir as a Chrome trace (chrome://tracing, Perfetto).
`synced_time`: best-of-iters seconds of a call, the device synchronised
after each. `StepTimer`: the training loop's iteration timer with an
exponential moving average.

The JAX module's `start_server` (a profiler server for on-demand capture
from TensorBoard) has no PyTorch counterpart: torch.profiler captures
what runs inside its context only, so `trace` is the way to a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profiles the enclosed block and writes log_dir/name (Chrome trace
    format); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _sync(out) -> None:
    """Waits for the work behind `out`: the card's, if a tensor of it is
    on a card (no-op on the CPU, which computes eagerly)."""
    def on_card(o):
        if isinstance(o, torch.Tensor):
            return o.is_cuda
        if isinstance(o, dict):
            return any(on_card(v) for v in o.values())
        if isinstance(o, (list, tuple)):
            return any(on_card(v) for v in o)
        return False

    if on_card(out):
        torch.cuda.synchronize()


def synced_time(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Best-of-iters wall time (seconds) of fn(*args), each call timed
    until the device has finished the work behind its output."""
    for _ in range(warmup):
        _sync(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


class StepTimer:
    """Iteration timer with an exponential moving average (the
    reference's IterTimerHook)."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else (
            self.momentum * self.avg + (1 - self.momentum) * dt)
        return dt
