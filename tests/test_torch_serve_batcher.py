"""The port's serving micro-batcher (edgecape_tpu_torch/cli/serve.py
_MicroBatcher) through the five cases of tests/test_serve_batcher.py,
each run on the port's batcher and on serve.py's, so that the two
coalesce alike (no model, no device).

A fake service records every _dispatch, so the tests assert the
coalescing contract directly: concurrent same-context requests share one
device call, different contexts split, errors fan out to all waiters.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import serve
import torch_threads  # caps torch's threads per worker; waits
from edgecape_tpu_torch.cli import serve as tserve

MODULES = pytest.mark.parametrize("mod", [tserve, serve],
                                  ids=["port", "serve.py"])


class _FakeService:
    def __init__(self, fail_for=()):
        self.calls = []  # (cid, batch_n)
        self.fail_for = set(fail_for)
        self.lock = threading.Lock()

    def _dispatch(self, cid, imgs):
        with self.lock:
            self.calls.append((cid, imgs.shape[0]))
        if cid in self.fail_for:
            raise KeyError("unknown context_id")
        # pred rows encode the input so callers can check routing:
        # each fake image is a constant plane, pred = that constant
        preds = np.stack([np.full((4, 2), float(img.flat[0]))
                          for img in imgs])
        return preds, [[0, 1, 0.5]], 4


def _img(v):
    return np.full((8, 8, 3), float(v), np.float32)


@MODULES
def test_concurrent_same_context_coalesce(mod):
    svc = _FakeService()
    batcher = mod._MicroBatcher(svc, window_s=0.05)
    results = {}

    def worker(v):
        results[v] = batcher.submit("ctx-a", _img(v), scale=1.0)

    threads = [threading.Thread(target=worker, args=(v,), daemon=True)
               for v in range(5)]
    for t in threads:
        t.start()
    torch_threads.join_threads(threads, "the batcher's callers")
    batcher.stop()

    # all five answered, routed to their own rows
    for v in range(5):
        assert results[v]["pred"][0, 0] == float(v)
        assert results[v]["edges"] == [[0, 1, 0.5]]
        assert results[v]["k_real"] == 4
    # coalesced: fewer dispatches than requests, all for ctx-a
    assert all(cid == "ctx-a" for cid, _ in svc.calls)
    assert len(svc.calls) < 5
    assert sum(n for _, n in svc.calls) == 5


@MODULES
def test_mixed_contexts_split_dispatches(mod):
    svc = _FakeService()
    batcher = mod._MicroBatcher(svc, window_s=0.05)
    results = {}

    def worker(key, cid, v):
        results[key] = batcher.submit(cid, _img(v), scale=1.0)

    threads = [
        threading.Thread(target=worker, args=a, daemon=True)
        for a in (("a0", "ctx-a", 1), ("b0", "ctx-b", 2), ("a1", "ctx-a", 3))
    ]
    for t in threads:
        t.start()
    torch_threads.join_threads(threads, "the batcher's callers")
    batcher.stop()

    assert results["a0"]["pred"][0, 0] == 1.0
    assert results["b0"]["pred"][0, 0] == 2.0
    assert results["a1"]["pred"][0, 0] == 3.0
    by_cid = {}
    for cid, n in svc.calls:
        by_cid[cid] = by_cid.get(cid, 0) + n
    assert by_cid == {"ctx-a": 2, "ctx-b": 1}


@MODULES
def test_dispatch_error_fans_out_to_all_waiters(mod):
    svc = _FakeService(fail_for={"ctx-bad"})
    batcher = mod._MicroBatcher(svc, window_s=0.05)
    errors = {}

    def worker(v):
        try:
            batcher.submit("ctx-bad", _img(v), scale=1.0)
        except RuntimeError as e:
            errors[v] = str(e)

    threads = [threading.Thread(target=worker, args=(v,), daemon=True)
               for v in range(3)]
    for t in threads:
        t.start()
    torch_threads.join_threads(threads, "the batcher's callers")
    batcher.stop()

    assert set(errors) == {0, 1, 2}
    assert all("unknown context_id" in e for e in errors.values())


@MODULES
def test_max_batch_respected(mod):
    svc = _FakeService()
    batcher = mod._MicroBatcher(svc, window_s=0.05, max_batch=2)
    threads = [threading.Thread(
        target=lambda v=v: batcher.submit("c", _img(v), scale=1.0),
        daemon=True) for v in range(5)]
    for t in threads:
        t.start()
    torch_threads.join_threads(threads, "the batcher's callers")
    batcher.stop()
    assert max(n for _, n in svc.calls) <= 2
    assert sum(n for _, n in svc.calls) == 5


@MODULES
def test_stop_drains_cleanly(mod):
    svc = _FakeService()
    batcher = mod._MicroBatcher(svc, window_s=0.0)
    out = batcher.submit("c", _img(7), scale=1.0)
    assert out["pred"][0, 0] == 7.0
    batcher.stop()
    assert not batcher.thread.is_alive()
