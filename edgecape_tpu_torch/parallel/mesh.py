"""The data-parallel layout; counterpart of edgecape_tpu/parallel/mesh.py.

JAX's 1-D `data` mesh shards the batch axis over devices and replicates
the parameters; XLA inserts the gradient psum. A torch process drives one
device, so the same layout is one process per device, and the mesh is
the process group itself: its size and this process's place in it are
`multihost.process_count()` / `process_index()`, which the trainer and
the eval runner read (no mesh record is passed around). `shard_batch`
and `replicate` are multihost.shard_batch_global / replicate_global, and
the trainer reduces the gradients explicitly (train/loop.py).
`make_mesh`, `batch_sharding` and `replicated` have no counterpart:
there is no sharding object to name. `pad_to_multiple` is the same numpy
copy as the JAX package's.
"""

from __future__ import annotations

import numpy as np


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad the batch axis so it divides the mesh; returns (padded, n_real)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, rem)
    return np.pad(arr, pad_width, mode="edge"), n
