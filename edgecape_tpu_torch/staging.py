"""Host arrays to the model's device.

A copy from ordinary (pageable) host memory to a CUDA device blocks the
host until it is done, whatever `non_blocking` says, and moves at the
rate of CUDA's own staging. `HostStager` therefore keeps page-locked buffers:
a large array is copied into one on the host and sent from there with an
asynchronous copy, so the transfer runs under the device's work and the
host goes on. Each (name, shape, dtype) has up to two buffers; a buffer is
written again only after the event recorded behind its last transfer has
completed, and the second is made only when the first is still being read
at the next call. Small arrays and every array bound for the CPU take the
plain `Tensor.to`: `device="cpu"` never touches a pinned buffer.

A stager may be called from several threads (a server's request threads
and its batching worker share one estimator): choosing a slot, writing
its buffer and recording its event happen under one lock, so no two
calls ever write one buffer at a time.
"""

from __future__ import annotations

import threading

import torch

# arrays below this many bytes are sent as they are: CUDA's own
# staging of a small pageable copy does not hold the host for long
MIN_STAGED_BYTES = 1 << 20
SLOTS = 2


class _Slot:
    __slots__ = ("buffer", "event")

    def __init__(self, buffer, event):
        self.buffer, self.event = buffer, event


class HostStager:
    """stager(array, name) -> the array's values as a tensor on `device`.

    `staged`: copies that went through a pinned buffer; `direct`: copies
    that did not. `alloc` and `new_event` make the buffers and the events
    (page-locked memory and CUDA events unless given)."""

    def __init__(self, device, *, alloc=None, new_event=None):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.min_bytes = MIN_STAGED_BYTES
        self._alloc = alloc or (lambda shape, dtype: torch.empty(
            shape, dtype=dtype, pin_memory=True))
        self._new_event = new_event or torch.cuda.Event
        self._slots = {}         # (name, shape, dtype) -> its slots, oldest first
        self._lock = threading.Lock()
        self.staged = 0
        self.direct = 0

    def __call__(self, array, name: str = "") -> torch.Tensor:
        src = torch.as_tensor(array)
        if (not self.pinned or src.is_cuda
                or src.numel() * src.element_size() < self.min_bytes):
            self.direct += 1
            return src.to(self.device, non_blocking=True)
        key = (name, tuple(src.shape), src.dtype)
        with self._lock:
            ring = self._slots.setdefault(key, [])
            slot = next((sl for sl in ring if sl.event.query()), None)
            if slot is None and len(ring) < SLOTS:
                slot = _Slot(self._alloc(tuple(src.shape), src.dtype),
                             self._new_event())
            elif slot is None:
                slot = ring[0]
                slot.event.synchronize()   # its last transfer has read it
            if slot in ring:
                ring.remove(slot)
            ring.append(slot)
            slot.buffer.copy_(src)
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            out.copy_(slot.buffer, non_blocking=True)
            slot.event.record()
            self.staged += 1
        return out
