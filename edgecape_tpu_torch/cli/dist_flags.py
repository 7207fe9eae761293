"""The multi-process flags of the CLIs (`--dist-coordinator`,
`--dist-num-processes`, `--dist-process-id`, as test.py and train.py have
them) and the process setup they ask for.

One process per device: start N processes with the same flags and
process ids 0..N-1. On the card each process takes the card LOCAL_RANK
names when it is set, else `process_id % device_count`, and the group
runs NCCL; with `--device cpu` the group runs gloo on the host.
"""

from __future__ import annotations

import torch

from ..parallel import multihost


def add_flags(p) -> None:
    p.add_argument("--dist-coordinator", default=None,
                   help="address host:port of process 0 (or a torch "
                   "init_method URL such as file:///shared/path) for "
                   "multi-process runs, one process per device")
    p.add_argument("--dist-num-processes", type=int, default=None)
    p.add_argument("--dist-process-id", type=int, default=None)


def setup(args) -> torch.device:
    """Joins the process group the flags name (NCCL on the card, gloo
    with --device cpu) and returns this process's device; without the
    flags, args.device as the entry points resolve it."""
    from ..api import resolve_device
    if args.dist_num_processes in (None, 1) and args.dist_coordinator is None:
        return resolve_device(args.device)
    kind = torch.device(args.device).type
    pid = args.dist_process_id or 0
    device = multihost.local_device(kind, pid)
    multihost.initialize(args.dist_coordinator, args.dist_num_processes,
                         args.dist_process_id,
                         backend="nccl" if kind == "cuda" else "gloo",
                         device=device)
    return device
