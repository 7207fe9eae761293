"""The port's profiling utilities (utils/profiling.py) against the JAX
package's, and the stage profiler (tools/profile_eval_stages.py) on the
CPU at a toy case."""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from edgecape_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads while this file runs: the suite runs several
    files at once, and each worker's thread pool would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_synced_time_is_the_best_of_its_calls():
    calls = []

    def fn(x):
        calls.append(time.perf_counter())
        time.sleep(0.02 if len(calls) == 2 else 0.005)
        return {"out": [x * 2]}

    best = profiling.synced_time(fn, torch.ones(3), iters=3, warmup=1)
    assert len(calls) == 4                  # the warm-up call, then 3 timed
    assert 0.004 <= best < 0.02             # not the slow call


def test_step_timer_moving_average_matches_jax(monkeypatch):
    from edgecape_tpu.utils import profiling as jprof
    ticks = iter([0.0, 1.0, 2.0, 4.0, 10.0, 10.5] * 2)
    clock = lambda: next(ticks)                              # noqa: E731
    out = []
    for mod in (profiling, jprof):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        timer = mod.StepTimer(momentum=0.8)
        got = []
        for _ in range(3):
            timer.tic()
            got.append((timer.toc(), timer.avg))
        out.append(got)
    assert out[0] == out[1]
    assert out[0][-1] == (0.5, pytest.approx(0.8 * (0.8 * 1 + 0.2 * 2)
                                             + 0.2 * 0.5))


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(16, 16)
    with profiling.trace(str(tmp_path), name="t.json") as prof:
        y = x @ x
    assert prof is not None and y.shape == (16, 16)
    with open(os.path.join(tmp_path, "t.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_profile_eval_stages_toy_case_on_the_cpu(capsys):
    from edgecape_tpu_torch.tools import profile_eval_stages as P
    out = P.main(["--device", "cpu", "--case", "2,2,6,28", "--top", "3"])
    names = [r["stage"] for r in out["stages"]]
    assert names[0].startswith("backbone (4") and len(names) == 8
    assert names[-1] == "combined (chunk)"
    assert all(r["clock"] == "host" and r["ms"] > 0 and np.isfinite(r["ms"])
               for r in out["stages"])
    # the chunk's addmm attributed to the modules that issued it (the
    # layers of a stack as one site), top 3 + the rest
    assert out["clock"] == "host" and len(out["addmm"]) == 4
    assert all(n > 0 for _, n, _ in out["addmm"])
    assert out["addmm"][-1][2] == "other sites"
    assert all(site.startswith(("head.", "query_head.", "backbone",
                                "outside the modules"))
               for _, _, site in out["addmm"][:-1])
    assert any(".*." in site for _, _, site in out["addmm"])
    text = capsys.readouterr().out
    # a CPU run names no number a device time
    assert "host" in text and not re.search(r"device +\d|of device time",
                                            text)
    if not torch.cuda.is_available():       # the card is the default
        with pytest.raises(RuntimeError, match="CUDA"):
            P.main(["--case", "2,2,6,28"])
