"""The port's bench (edgecape_tpu_torch/tools/bench.py) against the
root-level bench.py, on the CPU: the phases its main runs (labels, order,
each child's flags, the attempts and timeouts given to each, the errors
of a budget that fits nothing) with the subprocess and the preflight
replaced by stubs, so that nothing runs; the three model recipes field for
field; the keys of every phase's result; the inputs both draw from seed 0,
bit for bit; the retryable-failure detector; the snapshot after each
phase and the SIGTERM flush (as tests/test_bench_resilience.py holds
bench.py's); the run without a card, which must fail with exit code 2 and
never measure the CPU in the card's place; and one toy `--device cpu`
call each of bench_eval and bench_train.

JAX's side is never run: its bench_eval / bench_train are called with the
estimator, the model, the optimizer and jit replaced by stubs that record
the arrays they are fed."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import select
import signal
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the root-level bench.py)

sys.path.remove(REPO)

import torch_threads  # caps torch's threads per worker
from edgecape_tpu_torch import config as C  # noqa: E402
from edgecape_tpu_torch.ops import counters  # noqa: E402
from edgecape_tpu_torch.tools import bench as tbench  # noqa: E402

TOY = dict(image_size=28, max_kpt=8, heatmap_size=8)
# the toy calls' head widths (the ViT-S/14 trunk stays)
NARROW = dict(d_model=32, num_feats=16, nhead=2, dim_feedforward=48,
              similarity_proj_dim=32, dynamic_proj_dim=16)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(module, monkeypatch, capsys, preflight_err=None, **kw):
    """module.main(**kw) with _attempts and preflight stubbed: ([(label,
    flags after the program, attempts, timeout)], the printed JSON
    lines). The child's flags drop the port's --device."""
    calls = []

    def attempts(argv, label, *, max_attempts, backoff_scale, timeout_s,
                 deadline=None):
        start = 2 if argv[1].endswith(".py") else 3
        flags = [a for a in argv[start:] if not a.startswith("--device=")]
        calls.append((label, flags, max_attempts, timeout_s))
        return {label: 1.0}, None

    monkeypatch.setattr(module, "_attempts", attempts)
    monkeypatch.setattr(module, "preflight", lambda **k: preflight_err)
    monkeypatch.setattr(module, "_switches", lambda: {})
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    capsys.readouterr()
    try:
        module.main(**kw)
    except SystemExit as e:
        assert e.code == 2
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return calls, lines


@pytest.mark.parametrize("kw", [
    {},
    {"with_5shot": False},
    {"shots": 5, "iters": 3},
    {"with_train": False, "with_disk": False, "groups": 4, "warmup": 0},
    {"only_phases": ["eval", "train_bf16_5shot", "eval_fp32"]},
    {"preflight_err": "no device"},
    {"budget_s": 10.0},
], ids=["defaults", "no-5shot", "shots5", "eval-only", "phases",
        "degraded", "no-budget"])
def test_main_runs_the_phases_of_bench_py(kw, monkeypatch, capsys):
    want, want_lines = _run_main(jbench, monkeypatch, capsys, **kw)
    got, got_lines = _run_main(tbench, monkeypatch, capsys, **kw)
    assert got == want
    assert [ln.get("errors") for ln in got_lines] == \
        [ln.get("errors") for ln in want_lines]
    if not kw:
        assert [c[0] for c in got] == [
            "eval", "eval5", "disk_eval", "train_fp32", "train_bf16",
            "train_fp32_5shot", "train_bf16_5shot", "eval_fp32"]


def test_child_argv_runs_the_module_on_the_device(monkeypatch, capsys):
    """The children are `python -m edgecape_tpu_torch.tools.bench
    --phase=...` with the parent's --device."""
    seen = []
    monkeypatch.setattr(tbench, "_attempts",
                        lambda argv, label, **k: (seen.append(argv)
                                                  or ({"value": 1.0}, None)))
    monkeypatch.setattr(tbench, "preflight", lambda **k: None)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    tbench.main(only_phases=["eval"], device="cpu")
    assert seen == [[sys.executable, "-m", "edgecape_tpu_torch.tools.bench",
                     "--phase=eval", "--groups=34", "--iters=10",
                     "--warmup=2", "--shots=1", "--device=cpu"]]
    a = tbench.parse_args(["--phases=eval,eval5", "--no-train", "--device",
                           "cpu", "--budget-s=5", "--backoff-scale=0"])
    assert (a.phases, a.no_train, a.device, a.budget_s, a.backoff_scale) \
        == ("eval,eval5", True, "cpu", 5.0, 0.0)


@pytest.mark.parametrize("recipe", [("bfloat16",), ("float32",),
                                    ("float32", False)])
def test_model_cfg_recipes_match_bench_py(recipe):
    got = dataclasses.asdict(tbench._model_cfg(*recipe))
    assert got == dataclasses.asdict(jbench._model_cfg(*recipe))
    assert isinstance(tbench._model_cfg(*recipe), C.ModelConfig)


def test_phase_results_have_bench_py_keys(monkeypatch, smoke):
    """Each phase's result keys, with the measuring functions stubbed;
    the default run's union is the list of keys the chip smoke requires
    of the port's run (chip_smoke.py BENCH_KEYS)."""
    disk = {"images_per_sec": 9.0, "host_collate_seconds": 1.0,
            "device_wait_seconds": 2.0, "dispatch_seconds": 3.0,
            "first_call_seconds": 4.0, "eval_seconds": 5.0}
    import jax

    # bench.py's run_phase sets the platform and a compilation cache dir
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    keys = {}
    for mod in (jbench, tbench):
        monkeypatch.setattr(mod, "bench_eval", lambda *a, **k: 500.0)
        monkeypatch.setattr(mod, "bench_train", lambda *a, **k: (10.0, 1.6))
        monkeypatch.setattr(mod, "bench_disk_eval", lambda *a, **k: disk)
        out = {}
        for phase, shots, iters in tbench.phase_specs():
            out.update(mod.run_phase(phase, 34, iters, 2, shots))
        keys[mod.__name__] = out
    assert keys["bench"] == keys["edgecape_tpu_torch.tools.bench"]
    assert set(keys["bench"]) == set(smoke.BENCH_KEYS)
    assert keys["bench"]["value_disk_split"]["first_call_s"] == 4.0


def _stub_modules(monkeypatch, **modules):
    """Stand-ins for JAX package modules in sys.modules: name (dots as
    double underscores) -> attributes; bench.py imports them inside its
    functions, so the stubs are what it finds. jax.numpy's array
    constructors and jax.random.PRNGKey become numpy's and the identity,
    so that nothing is traced or compiled."""
    import importlib
    import types

    import jax
    import jax.numpy as jnp
    for name, attrs in modules.items():
        mod = types.ModuleType("edgecape_tpu." + name.replace("__", "."))
        mod.__dict__.update(attrs)
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
        # `from package import module` finds a module imported before as
        # the package's attribute
        parent, _, leaf = mod.__name__.rpartition(".")
        monkeypatch.setattr(importlib.import_module(parent), leaf, mod,
                            raising=False)
    monkeypatch.setattr(jnp, "asarray", np.asarray)
    monkeypatch.setattr(jnp, "zeros", np.zeros)
    monkeypatch.setattr(jax.random, "PRNGKey", lambda seed: seed)


@pytest.mark.parametrize("shots", [1, 5])
def test_eval_inputs_equal_bench_py(shots, monkeypatch):
    seen = {}

    class Estimator:
        def __init__(self, cfg, rng=None):
            pass

        def forward_cached(self, support, query):
            if not seen:
                seen.update({k: np.asarray(v) for k, v in support.items()})
                seen.update({k: np.asarray(v) for k, v in query.items()})
            return np.zeros(1, np.float32), None

    _stub_modules(monkeypatch, api={"PoseEstimator": Estimator})
    mcfg = dataclasses.replace(jbench._model_cfg("bfloat16"), **TOY)
    jbench.bench_eval(mcfg, groups=3, iters=1, warmup=1, shots=shots)
    support, query = tbench.eval_inputs(3, shots, TOY["image_size"],
                                        TOY["max_kpt"])
    got = {**support, **query}
    assert sorted(got) == sorted(seen)
    for k in got:
        assert got[k].dtype == seen[k].dtype and \
            np.array_equal(got[k], seen[k]), k


@pytest.mark.parametrize("shots", [1, 5])
def test_train_batch_equals_bench_py(shots, monkeypatch):
    import jax
    import jax.numpy as jnp
    seen = {}

    class Model:
        def __init__(self, cfg):
            pass

        def init(self, *args):
            return {"params": {}}

    class Tx:
        def init(self, params):
            return None

    def make_step(*args):
        def step(state, bb, batch, key):
            if not seen:
                seen.update({k: np.asarray(v) for k, v in batch.items()})
            return state, {"loss": 0.0}
        return step

    monkeypatch.setattr(jax, "jit", lambda f, **k: f)
    monkeypatch.setattr(jnp, "int32", np.int32)
    _stub_modules(
        monkeypatch,
        models__dinov2={"init_params": lambda r, image_size: {},
                        "VIT_S14": None},
        models__edgecape={"EdgeCape": Model},
        train__loop={"TrainState": lambda **k: k,
                     "make_train_step": make_step},
        train__state={"make_optimizer": lambda *a: (Tx(), None)})
    mcfg = dataclasses.replace(jbench._model_cfg("float32"), **TOY)
    jbench.bench_train(mcfg, iters=1, warmup=1, batch_size=3, shots=shots)
    got = tbench.train_batch(3, shots, TOY["image_size"], TOY["max_kpt"],
                             TOY["heatmap_size"])
    assert list(got) == list(seen)
    for k in got:
        assert got[k].dtype == seen[k].dtype and \
            np.array_equal(got[k], seen[k]), k


@pytest.mark.parametrize("rc,output,want", [
    (1, "RuntimeError: CUDA driver initialization failed, you might not "
        "have a CUDA gpu.", True),
    (1, "RuntimeError: No CUDA GPUs are available", True),
    (1, "torch.AcceleratorError: CUDA error: CUDA-capable device(s) is/are "
        "busy or unavailable", True),
    (-9, "", True),
    (1, "AssertionError: shapes differ", False),
    (1, "AssertionError: Torch not compiled with CUDA enabled", False),
    (1, "RuntimeError: no CUDA device: the port runs on the GPU unless it "
        "is given device=\"cpu\"", False),
], ids=["driver-init", "no-gpus", "busy", "timeout", "assertion",
        "cpu-build", "no-device"])
def test_retryable_detector(rc, output, want):
    assert tbench._retryable(rc, output) is want


def test_snapshot_after_each_phase(monkeypatch, capsys):
    """One cumulative JSON line after every phase, with the switches the
    phases run; a failed phase lands in errors and the next still runs."""
    results = {"eval": ({"metric": "m", "value": 1.0}, None),
               "eval5": (None, "rc=1; tail: boom"),
               "disk_eval": ({"value_disk": 2.0}, None)}
    monkeypatch.setattr(tbench, "_attempts",
                        lambda argv, label, **k: results[label])
    monkeypatch.setattr(tbench, "preflight", lambda **k: None)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    tbench.main(with_train=False, with_fp32=False)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [sorted(set(ln) - {"kernel_switches"}) for ln in lines] == [
        ["metric", "value"], ["errors", "metric", "value"],
        ["errors", "metric", "value", "value_disk"],
        ["errors", "metric", "value", "value_disk"]]
    assert lines[-1]["errors"] == {"eval5": "rc=1; tail: boom"}
    assert all(set(ln["kernel_switches"]) == {
        "encoder_stack", "decoder_stack", "vit_pair_blocks"} for ln in lines)
    assert lines[0]["kernel_switches"]["encoder_stack"] is True


SIGTERM_SCRIPT = r"""
import sys, time
from edgecape_tpu_torch.tools import bench as B
def attempts(argv, label, **kw):
    if label == "eval":
        return {"metric": "m", "value": 1.0}, None
    time.sleep(60)
B._attempts = attempts
B.preflight = lambda **kw: None
B.main()
"""


def test_sigterm_midrun_flushes_the_snapshot():
    """SIGTERM during the second phase: the last line holds the first
    phase's result and errors.killed; exit code 1."""
    proc = subprocess.Popen([sys.executable, "-c", SIGTERM_SCRIPT], cwd=REPO,
                            env=torch_threads.child_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        # the snapshot after "eval", within the child's time limit
        ready, _, _ = select.select([proc.stdout], [], [],
                                    torch_threads.CHILD_TIMEOUT)
        if not ready:
            proc.kill()
            pytest.fail(f"the bench child printed no snapshot within "
                        f"{torch_threads.CHILD_TIMEOUT} s:\n"
                        f"{proc.communicate()[1][-3000:]}")
        first = proc.stdout.readline()
        assert json.loads(first)["value"] == 1.0
        proc.send_signal(signal.SIGTERM)
        (_, out, err), = torch_threads.wait_children(
            [("the bench child after SIGTERM", proc, None)], 60)
    finally:
        proc.kill()
    snap = json.loads(out.splitlines()[-1])
    assert "killed" in snap["errors"], (out, err)
    assert snap["value"] == 1.0 and "kernel_switches" in snap
    assert proc.returncode == 1


def _child_in_process(argv, timeout_s):
    """tools/bench.py _run_child with the child's work done in this
    process: the preflight's code, or `--phase=...` through run_phase as
    the module's __main__ runs it; (rc, output) as a child would give."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            if argv[1] == "-c":
                exec(argv[2], {})
            else:
                a = tbench.parse_args(argv[3:])
                print(json.dumps(tbench.run_phase(
                    a.phase, a.groups, a.iters, a.warmup, a.shots,
                    device=a.device)))
        return 0, out.getvalue()
    except Exception:
        return 1, out.getvalue() + traceback.format_exc()


def test_without_a_card_nothing_is_measured(monkeypatch, capsys):
    """No card and no --device cpu: the preflight and the phase fail, the
    last line names both, exit code 2, the run degraded; nothing fell back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(tbench, "_run_child", _child_in_process)
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    with pytest.raises(SystemExit) as exit_:
        tbench.main(only_phases=["eval"], backoff_scale=0)
    assert exit_.value.code == 2
    printed = capsys.readouterr()
    out = json.loads(printed.out.splitlines()[-1])
    assert set(out) == {"errors", "kernel_switches"}
    assert set(out["errors"]) == {"preflight", "eval"}
    assert "no CUDA device" in out["errors"]["eval"]
    assert "DEGRADED" in printed.err


def test_bench_eval_toy_on_cpu():
    """bench_eval on the CPU at a toy size: a finite positive rate, no
    kernel launched (a kernel op takes its plain version on the CPU)."""
    before = counters.launch_counts()
    mcfg = C.replace(tbench._model_cfg("bfloat16"), **TOY, **NARROW)
    v = tbench.bench_eval(mcfg, groups=1, iters=1, warmup=0, device="cpu")
    assert np.isfinite(v) and v > 0
    assert counters.launch_counts() == before


def test_bench_train_toy_on_cpu():
    mcfg = C.replace(tbench._model_cfg("bfloat16"), **TOY, **NARROW)
    ms, eps = tbench.bench_train(mcfg, iters=1, warmup=0, batch_size=2,
                                 device="cpu")
    assert np.isfinite(ms) and ms > 0
    assert eps == pytest.approx(2 / (ms / 1000.0))


def _bench_output(smoke, fault):
    """(rc, stdout, stderr) of a bench run as the smoke reads it, good
    but for `fault`."""
    switches = {"encoder_stack": True, "decoder_stack": True,
                "vit_pair_blocks": fault != "switches"}
    out = dict({k: 1.0 for k in smoke.BENCH_KEYS},
               kernel_switches=switches)
    if fault == "errors":
        out["errors"] = {"eval5": "rc=1"}
    if fault == "missing-key":
        del out["value_fp32"]
    ops = {name: 0 for name, _, _ in counters.OP_COUNTERS}
    err = []
    for label, need in smoke.bench_needs(switches).items():
        c = {"ops": dict(ops, **dict.fromkeys(need, 3)),
             "kernels": {"vit_mlp_kernel": 3} if need else {}}
        if fault == "plain-eval" and label == "eval":
            c = {"ops": ops, "kernels": {}}
        if fault == "fp32-kernel" and label == "eval_fp32":
            c["kernels"] = {"attn_kernel": 1}
        if fault == "lost-phase" and label == "train_bf16_5shot":
            continue
        if fault == "retried" and label == "eval5":
            err += ["[bench] phase eval5 attempt 1/3 failed "
                    "(device-init/timeout); rc=-9",
                    "[bench] retrying eval5 in 30s"]
        err.append(f"[bench] phase {label} launches {json.dumps(c)}")
    if fault == "degraded":
        err.insert(0, "[bench] preflight NEVER succeeded; DEGRADED mode — "
                   "one <= 120s attempt per phase")
    return (1 if fault == "rc" else 0), json.dumps(out) + "\n", \
        "\n".join(err) + "\n"


@pytest.mark.parametrize("fault", [None, "rc", "errors", "missing-key",
                                   "plain-eval", "fp32-kernel",
                                   "lost-phase", "switches", "retried",
                                   "degraded"])
def test_smoke_benchrun_gates(fault, smoke, monkeypatch, capsys):
    """chip_smoke.py bench_run on a faked bench run (the measured-defaults
    file with both switches on): it asks for one attempt a phase, passes a
    good run and fails one with a non-zero exit code, errors, a missing
    key, an eval phase that ran the plain path, a strict fp32 eval that
    launched a kernel, a phase without counters, other switches than the
    file's, a phase that passed only on a retry, or DEGRADED mode."""
    from edgecape_tpu_torch.ops import kernel_config
    rc, out, err = _bench_output(smoke, fault)
    argvs = []
    monkeypatch.setattr(smoke.subprocess, "run", lambda *a, **k: (
        argvs.append(a[0])
        or subprocess.CompletedProcess(a[0], rc, out, err)))
    monkeypatch.setattr(kernel_config, "_tuned", lambda: {
        "decoder_stack": True, "vit_pair_blocks": True})
    if fault is None:
        smoke.bench_run("card, 700 W", {"path": 1.0})
    else:
        with pytest.raises(SystemExit):
            smoke.bench_run("card, 700 W", {"path": 1.0})
    assert "[benchrun]" in capsys.readouterr().out
    assert "--max-attempts=1" in argvs[0]
