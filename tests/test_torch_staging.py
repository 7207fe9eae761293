"""staging.HostStager across threads: a server's request threads and its
batching worker share one estimator, and so one stager. Choosing a slot,
writing its pinned buffer and recording its event are one step under a
lock, so two threads never write one buffer while its transfer is in
flight. Buffers and events are injected fakes (no card)."""

import threading

import numpy as np
import torch

import torch_threads  # caps torch's threads per worker; waits
from edgecape_tpu_torch import staging


def test_two_threads_never_share_a_buffer():
    """Both threads reach the free-slot check together (a barrier inside
    the event's query): without the lock both take the one free buffer;
    with it the second finds that buffer in flight and gets its own."""
    barrier = threading.Barrier(2)
    overwritten = []

    class InFlightEvent:
        """Complete until recorded, in flight until waited for."""

        def __init__(self):
            self.in_flight = False

        def record(self):
            if self.in_flight:
                overwritten.append(self)
            self.in_flight = True

        def query(self):
            try:
                barrier.wait(timeout=1.0)
            except threading.BrokenBarrierError:
                pass
            return not self.in_flight

        def synchronize(self):
            self.in_flight = False

    made = []

    def alloc(shape, dtype):
        made.append(torch.empty(shape, dtype=dtype))
        return made[-1]

    st = staging.HostStager("cpu", alloc=alloc, new_event=InFlightEvent)
    st.pinned = True                  # the buffered route without a card
    shape = (600, 600)
    first = np.zeros(shape, np.float32)
    barrier.abort()                   # the first call runs alone
    st(first, "img_q")
    ring = st._slots[("img_q", shape, torch.float32)]
    ring[0].event.synchronize()       # its transfer is done: one free slot
    barrier.reset()

    arrays = [np.full(shape, i + 1, np.float32) for i in range(2)]
    outs = [None, None]

    def stage(i):
        outs[i] = st(arrays[i], "img_q")

    threads = [threading.Thread(target=stage, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    torch_threads.join_threads(threads, "the two staging threads")
    assert not overwritten, "a buffer was written while in flight"
    assert len(made) == 2 and st.staged == 3
    for a, out in zip(arrays, outs):
        assert np.array_equal(out.numpy(), a)
