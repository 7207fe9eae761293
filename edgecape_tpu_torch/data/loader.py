"""Asynchronous episode prefetcher; counterpart of
edgecape_tpu/data/loader.py.

Host-side collation (image decode + warp + heatmaps) of a batch takes
longer single-threaded than the device needs for a train step. This
loader keeps a bounded queue of ready batches built by worker threads
(the warp and heatmap math runs in the C++ core, which releases the GIL),
overlapping host preprocessing with device compute.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import numpy as np

from .mp100 import EpisodeBatch, MP100Dataset


class Prefetcher:
    """Iterates `dataset` in batches, built ahead by worker threads.

    Epoch semantics match MP100Dataset.batches (shuffle + drop_last); the
    per-batch rng state is pre-split on the main thread so augmentation
    draws are deterministic regardless of worker scheduling.
    """

    def __init__(self, dataset: MP100Dataset, batch_size: int, *,
                 shuffle: bool = True, masking_ratio: float = 0.0,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch_depth: int = 4,
                 use_native: Optional[bool] = None,
                 seed: int = 0,
                 shard: Optional[tuple] = None):
        """`shard=(index, count)` makes each of `count` processes collate
        only its contiguous row slice of every (identically planned)
        batch — host preprocessing scales with process count, and the
        per-SAMPLE rng plan keeps each slice bit-identical to the
        corresponding rows of the unsharded batch (a DistributedSampler
        for episodic batches)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.masking_ratio = masking_ratio
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        if use_native is None:
            # auto: the C++ core renders biased-MSRA / UDP targets only, so
            # unbiased_encoding takes the python collate (an explicit
            # use_native=True still raises in collate_native). A core that
            # does not build raises at the first batch; it is not replaced
            # by the python collate.
            unbiased = (getattr(dataset.cfg, "unbiased_encoding", False)
                        and not dataset.cfg.use_udp)
            self.use_native = not unbiased
        else:
            self.use_native = use_native
        self.rng = np.random.default_rng(seed)
        if shard is not None:
            index, count = shard
            assert batch_size % count == 0, \
                f"batch {batch_size} not divisible by {count} processes"
            self.shard = (int(index), int(count))
        else:
            self.shard = None

    def _plan_epoch(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        chunks = []
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            # deterministic per-SAMPLE augmentation streams: any row
            # slice of the batch reproduces exactly, independent of what
            # other rows (or processes) consume
            seeds = self.rng.integers(2**63, size=len(chunk))
            rngs = [np.random.default_rng(s) for s in seeds]
            chunks.append((list(chunk), rngs))
        return chunks

    def _build(self, chunk, rngs) -> EpisodeBatch:
        ds = self.dataset
        if self.shard is not None:
            i, p = self.shard
            per = len(chunk) // p
            chunk = chunk[i * per:(i + 1) * per]
            rngs = rngs[i * per:(i + 1) * per]
        if self.use_native:
            return ds.collate_native(chunk, rng=rngs,
                                     masking_ratio=self.masking_ratio,
                                     num_threads=1)
        return ds.collate(chunk, rng=rngs,
                          masking_ratio=self.masking_ratio)

    def epoch(self) -> Iterator[EpisodeBatch]:
        chunks = self._plan_epoch()
        permits = threading.Semaphore(self.prefetch_depth)  # bound lookahead
        idx_lock = threading.Lock()
        state = {"next": 0, "stop": False}
        results: dict = {}
        cond = threading.Condition()

        def worker():
            while True:
                permits.acquire()
                with idx_lock:
                    if state["stop"] or state["next"] >= len(chunks):
                        permits.release()
                        return
                    i = state["next"]
                    state["next"] = i + 1
                try:
                    batch = self._build(*chunks[i])
                except BaseException as e:   # handed to the consumer
                    batch = e
                with cond:
                    results[i] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(chunks)):
                with cond:
                    while i not in results:
                        cond.wait()
                    batch = results.pop(i)
                permits.release()
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            with idx_lock:
                state["stop"] = True
            permits.release()  # unblock a potentially waiting worker
            for t in threads:
                t.join(timeout=5)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n
