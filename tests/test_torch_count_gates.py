"""The smoke's kernel-count gates (chip_smoke.py device_extra) when a
profiler trace loses its device events: the count then comes from the
wrappers' exact launch counters (ops/kernels.py launch_counts), the cap
and the must-run check hold on it, the time reads "not measured", and an
op with no count from either source fails; and how a trace's kernels are
matched to the timed calls (tools/bench_attention.py span_work: by
correlation id, whatever the device's timestamps say). The traces and the
launches are faked: this runs on the CPU."""

import importlib.util
import os

import pytest

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.tools import bench_attention as BA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = ("vit_qkv_kernel", "vit_attn_kernel", "vit_mlp_kernel")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vit_block():
    """What the wrappers count for one fused_vit_block call."""
    K.launches["vit_qkv_kernel"] += 1
    K.launches["vit_attn_kernel"] += 1
    K.launches["vit_mlp_kernel"] += 1


def attention_half():
    K.launches["vit_qkv_kernel"] += 1
    K.launches["vit_attn_kernel"] += 1


def nothing():
    pass


LOST = [(None, None, 2.5), (1.75, float("nan"), None), (1.75, 2.5, None)]


@pytest.fixture(params=LOST, ids=["no device events", "nan count",
                                  "no whole count"])
def lost_trace(request, monkeypatch):
    monkeypatch.setattr(BA, "device_ms", lambda fn, reps=BA.REPS:
                        request.param)
    monkeypatch.setattr(BA, "kernel_ms", lambda fn, reps=BA.REPS: {})
    return request.param


def test_within_the_counters_passes_and_says_not_measured(smoke, lost_trace):
    bad = []
    text, dev_ms, per_call, by_name = smoke.device_extra(
        "fused_vit_block", vit_block, 3, bad, VIT)
    assert bad == [] and per_call == 3 and by_name == {}
    assert dev_ms is None and "device not measured" in text
    assert "3 kernels per call by launch counters" in text
    if lost_trace[2] is not None:
        assert "wall 2.5000 ms (CUDA events)" in text


def test_over_the_cap_by_the_counters_fails(smoke, lost_trace):
    bad = []
    smoke.device_extra("fused_attn_block", vit_block, 2, bad, VIT[:2])
    assert bad == ["fused_attn_block: 3 kernels per call"]


def test_a_missing_must_run_kernel_by_the_counters_fails(smoke, lost_trace):
    bad = []
    smoke.device_extra("fused_vit_block", attention_half, 3, bad, VIT)
    assert bad == ["fused_vit_block: ['vit_mlp_kernel'] did not run"]


def test_no_count_from_either_source_fails(smoke, lost_trace):
    bad = []
    text, _, per_call, _ = smoke.device_extra("fused_ln_mlp", nothing, 1,
                                              bad)
    assert per_call is None
    assert len(bad) == 1 and "no kernel count" in bad[0]


def test_a_whole_trace_count_is_taken(smoke, monkeypatch):
    """A trace with its device events: its time and count, its kernels for
    the must-run check."""
    monkeypatch.setattr(BA, "device_ms", lambda fn, reps=BA.REPS:
                        (1.25, 3, None))
    monkeypatch.setattr(BA, "kernel_ms", lambda fn, reps=BA.REPS: {
        f"void {k}(CUtensorMap_st)": 0.4 for k in VIT})
    bad = []
    text, dev_ms, per_call, _ = smoke.device_extra(
        "fused_vit_block", vit_block, 3, bad, VIT)
    assert bad == [] and dev_ms == 1.25 and per_call == 3
    assert "device 1.2500 ms in 3 kernels per call by trace" in text
    bad = []
    smoke.device_extra("fused_vit_block", vit_block, 2, bad, VIT)
    assert bad == ["fused_vit_block: 3 kernels per call"]


def test_launch_counts_name_every_counted_kernel():
    """Each wrapper counter appears under its kernel's name, and one launch
    moves exactly its own entry."""
    counts = K.launch_counts()
    for name in ("gemm_tma_kernel", "enc_post_kernel", "dec_post_cross_kernel",
                 "bias_attn_kernel", "kpt_head_kernel", "attn_kernel",
                 "add_pos_kernel", "sine_feats_kernel", "mm_chain_kernel",
                 "train_bwd_q_kernel") + VIT:
        assert name in counts
    assert BA.launched(vit_block) == {k: 1 for k in VIT}
    assert BA.launched(nothing) == {}


def _trace(skew, lose=None):
    """A profiler trace's events: a warm call (correlation 1) before the
    span at 0-1000 us, then three calls (2-4) each launching one kernel
    and one host-to-device copy (5-7); every device timestamp shifted by
    `skew` us against the host's clock, the kernel of correlation `lose`
    missing."""
    def host(c, ts, name="cudaLaunchKernel"):
        return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
                "dur": 5, "args": {"correlation": c}}

    def dev(c, ts, cat="kernel", name="void vit_mlp_kernel<1>()"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts + skew,
                "dur": 200, "args": {"correlation": c}}

    ev = [{"ph": "X", "cat": "user_annotation", "name": "timed calls",
           "ts": 0, "dur": 1000}, host(1, -500), dev(1, -490),
          {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 10,
           "dur": 2}, host(8, 990, "cudaDeviceSynchronize")]
    for i, c in enumerate((2, 3, 4)):
        ev += [host(c, 100 + 300 * i), host(c + 3, 150 + 300 * i,
                                            "cudaMemcpyAsync"),
               dev(c + 3, 160 + 300 * i, "gpu_memcpy", "Memcpy HtoD")]
        if c != lose:
            ev.append(dev(c, 110 + 300 * i))
    return ev


@pytest.mark.parametrize("skew", [0.0, -3000.0, 2500.0])
def test_span_work_matches_device_work_to_calls_by_correlation(skew):
    """Device timestamps milliseconds off the host's clock (both ways):
    the three calls' kernels and copies are taken, the warm call's not."""
    work = BA.span_work(_trace(skew))
    assert sorted(cat for _, _, cat in work) == ["gpu_memcpy"] * 3 + [
        "kernel"] * 3
    assert all(dur == 200.0 for _, dur, _ in work)


def test_span_work_refuses_a_trace_that_lost_a_kernel():
    assert BA.span_work(_trace(0.0, lose=3)) is None
    assert BA.span_work([e for e in _trace(0.0)
                         if e["cat"] != "user_annotation"]) is None


def test_trace_skew_reads_how_far_the_device_clock_lies():
    """tools/trace_skew.py skew on the faked trace: device timestamps 3 ms
    behind put every kernel before its launch and before the span."""
    from edgecape_tpu_torch.tools import trace_skew as TS
    r = TS.skew(_trace(-3000.0))
    assert r == {"kernels": 4, "matched": 3, "by_start": 0,
                 "least_lead_us": -2990.0}
    assert TS.skew(_trace(0.0))["by_start"] == 3
