"""Multi-process utilities on torch.distributed; counterpart of
edgecape_tpu/parallel/multihost.py.

One process drives one device. The process group's backend is chosen by
the caller and named explicitly: NCCL for processes that each drive
their own card, gloo on the CPU (and for ranks that share one card,
which NCCL refuses). A collective moves its tensors where its backend
wants them: CUDA tensors on this process's card under NCCL, host
tensors under gloo; the results come back on the caller's side (numpy
for numpy, the input's device for tensors). A failed collective raises;
nothing falls back to another backend or to the CPU.

Single process (no process group): every function is a no-op or the
identity, so the same code runs everywhere.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist


def local_device(kind: str, process_id: int = 0) -> torch.device:
    """The device a process drives: the CPU for kind "cpu"; for "cuda"
    the card LOCAL_RANK names when it is set, else process_id modulo the
    cards of this host."""
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU unless "
                           "it is given device=\"cpu\"")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        process_id % torch.cuda.device_count()
    return torch.device("cuda", index)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               device: Optional[torch.device] = None) -> None:
    """Joins the process group (idempotent; a no-op for one process).

    coordinator_address: "host:port" of process 0 (a TCP rendezvous), or
    any torch init_method URL ("file://...", "tcp://..."). backend:
    "nccl" or "gloo", required with more than one process. device: the
    device this process drives; a CUDA device becomes the current one
    here, before any model or kernel touches a card (the kernels launch
    on the current device's stream and configure themselves once per
    process for it)."""
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != num_processes or \
                dist.get_rank() != process_id:
            raise RuntimeError(
                f"process group already joined as rank {dist.get_rank()} "
                f"of {dist.get_world_size()}, not {process_id} of "
                f"{num_processes}")
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl" and (device is None or device.type != "cuda"):
        raise ValueError("NCCL needs a CUDA device per process")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the number of processes and this "
                         "process's id")
    url = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def shutdown() -> None:
    """Leaves the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Waits for every process (no-op for one)."""
    if process_count() > 1:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where the backend takes its tensors: this process's card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_comm(a):
    """(a fresh tensor on the collective's device, a function back to
    the caller's kind). bool travels as uint8 (gloo has no bool
    gathers)."""
    dev = _comm_device()
    if isinstance(a, torch.Tensor):
        home = a.device
        t = a.detach()
        is_bool = t.dtype == torch.bool
        t = (t.to(torch.uint8) if is_bool else t).to(
            dev, copy=True).contiguous()
        return t, (lambda r: (r.bool() if is_bool else r).to(home))
    arr = np.asarray(a)
    is_bool = arr.dtype == np.bool_
    t = torch.from_numpy(np.ascontiguousarray(
        arr.astype(np.uint8) if is_bool else arr)).to(dev, copy=True)
    return t, (lambda r: r.cpu().numpy().astype(np.bool_) if is_bool
               else r.cpu().numpy())


def _map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def allgather(tree: Any) -> Any:
    """Fixed-shape arrays (numpy or tensors, any nesting of dicts, lists
    and tuples) from every process, each leaf stacked along a new leading
    process axis [P, ...]; the identity for one process."""
    if process_count() == 1:
        return tree
    p = process_count()

    def gather(a):
        t, back = _as_comm(a)
        out = [torch.empty_like(t) for _ in range(p)]
        dist.all_gather(out, t)
        return back(torch.stack(out))

    return _map(gather, tree)


def allreduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """The elementwise sum over processes, on the input's device (a new
    tensor); the input itself for one process."""
    if process_count() == 1:
        return tensor
    t, back = _as_comm(tensor)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return back(t)


def broadcast(tree: Any) -> Any:
    """Process 0's arrays (numpy or tensors) to every process; the
    identity for one process."""
    if process_count() == 1:
        return tree

    def bcast(a):
        t, back = _as_comm(a)
        dist.broadcast(t, src=0)
        return back(t)

    return _map(bcast, tree)


def shard_range(n: int) -> range:
    """This process's contiguous slice of [0, n) (the role of a
    DistributedSampler for episode groups and rows)."""
    p, i = process_count(), process_index()
    per = (n + p - 1) // p
    return range(i * per, min((i + 1) * per, n))


# ---------------------------------------------------------------- global
# state: a torch process holds one device, so "global" arrays are the
# per-process copies kept equal (replicated) or the per-process row
# blocks of one global batch (sharded).

def replicate_global(tree: Any) -> Any:
    """Process 0's copy of a tree that should be the same everywhere (a
    state dict), given to every process."""
    return broadcast(tree)


def shard_batch_global(tree: Any) -> Any:
    """A host batch tree that every process holds in full -> this
    process's contiguous row block of it (every leaf's leading axis must
    divide by the process count)."""
    p, i = process_count(), process_index()
    if p == 1:
        return tree

    def block(a):
        n = a.shape[0]
        assert n % p == 0, f"batch {n} not divisible by {p} processes"
        per = n // p
        return a[i * per:(i + 1) * per]

    return _map(block, tree)


def to_host(tree: Any) -> Any:
    """Tensors -> host numpy arrays (everything else as it is)."""
    return _map(lambda a: a.detach().cpu().numpy()
                if isinstance(a, torch.Tensor) else a, tree)
