"""Benchmark of the port: MP-100 1-shot eval throughput (images/s on one
card); counterpart of the root-level bench.py, phase for phase and key for
key.

    python -m edgecape_tpu_torch.tools.bench            # every phase, on the card
    python -m edgecape_tpu_torch.tools.bench --device cpu --groups=1 \\
        --iters=1 --warmup=0 --phases=eval             # a toy run on the CPU

Baseline: the reference evaluates the full MP-100 1-shot test split
(100 classes x 200 episodes x 15 queries = 300k query images) in ~30 min
on one GPU (reference README.md:87) => ~167 images/s; vs_baseline is this
card's throughput over that number. One process drives one card, so the
per-chip figure is the process's own: nothing is divided by the device
count.

Phases, each in its own subprocess (`--phase=NAME` runs one and prints its
JSON line), in this order: `eval` (the headline: cached eval at the test
shape, bf16 with the kernels), `eval5` (5 shots), `disk_eval` (synthetic
images on disk through the loader and `eval/runner.run_eval`), the
training step (`train_fp32`, `train_bf16`, and their 5-shot forms), and
`eval_fp32` last (the strict path: float32, `use_flash=False`, plain
modules, TF32 off under `api.strict_fp32`). The kernel phases run the
variant switches as `hopper_tuned.json` has them, as the CLIs do; every
snapshot names them under `kernel_switches`. Each phase child prints, on
stderr, the launch counters of the kernel ops and kernels it ran
(`[bench] launches {...}`), which the parent passes on as `[bench] phase
LABEL launches {...}`: a phase that quietly ran the plain path shows 0.

Prints ONE JSON line after every phase, the cumulative snapshot: {"metric",
"value", "unit", "vs_baseline"} of the headline, then value_5shot,
value_disk with value_disk_split, train_ms_per_step_{fp32,bf16}[_5shot] and
train_episodes_per_sec_{fp32,bf16}[_5shot], value_fp32; "errors" where a
phase failed. The last line is the one to read.

Resilience, as bench.py's: a preflight (a tiny matmul on the device in a
subprocess) prints the device's name, count and init seconds first; a
phase whose child failed on a transient device initialisation error or
timed out is retried with exponential backoff; every retry and sleep is
clamped against one wall-clock deadline (`--budget-s`, or the environment
variable BENCH_BUDGET_S); when the preflight never succeeds the run drops
to DEGRADED mode (one short attempt per phase); SIGTERM flushes the
snapshot with errors.killed; exit code 2 when nothing was measured.
There is no fallback: without a card and without `--device cpu` the
preflight and every phase fail, and the last line carries their errors.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

BASELINE_IMG_PER_SEC = 300000 / 1800.0  # reference: 30 min on 1 GPU
QUERIES_PER_EPISODE = 15                # test protocol

MODULE = "edgecape_tpu_torch.tools.bench"
# the directory that holds the package: the children import it from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def train_batch(b: int, shots: int, size: int, k: int, hs: int) -> dict:
    """The training batch bench.py draws (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "img_s": rng.normal(size=(b, shots, size, size, 3)).astype(
            np.float32),
        "img_q": rng.normal(size=(b, size, size, 3)).astype(np.float32),
        "joints_s": rng.uniform(10, size - 10,
                                size=(b, shots, k, 2)).astype(np.float32),
        "vis_s": np.ones((b, shots, k), np.float32),
        "target_q": rng.uniform(size=(b, k, hs, hs)).astype(np.float32),
        "weight_q": np.ones((b, k), np.float32),
        "joints_q": rng.uniform(0, size, size=(b, k, 2)).astype(np.float32),
        "binary_adj": np.tile(np.eye(k, k=1, dtype=np.float32)
                              + np.eye(k, k=-1, dtype=np.float32),
                              (b, 1, 1)),
        "rand_mask": (rng.uniform(size=(b, k)) > 0.3).astype(np.float32),
    }


def eval_inputs(g: int, s: int, size: int, k: int):
    """(support, query): the episodes bench.py draws (numpy, seed 0), g
    groups of s shots and QUERIES_PER_EPISODE queries each."""
    nq = g * QUERIES_PER_EPISODE
    rng = np.random.default_rng(0)
    support = {
        "img_s": rng.normal(size=(g, s, size, size, 3)).astype(np.float32),
        "joints_s": rng.uniform(10, size - 10,
                                size=(g, s, k, 2)).astype(np.float32),
        "vis_s": np.ones((g, s, k), np.float32),
        "binary_adj": np.tile(np.eye(k, k=1, dtype=np.float32)
                              + np.eye(k, k=-1, dtype=np.float32),
                              (g, 1, 1)),
    }
    query = {
        "img_q": rng.normal(size=(nq, size, size, 3)).astype(np.float32),
        "group": np.repeat(np.arange(g, dtype=np.int32),
                           QUERIES_PER_EPISODE),
    }
    return support, query


def bench_train(mcfg, iters: int = 10, warmup: int = 3,
                batch_size: int = 16, shots: int = 1, device="cuda"):
    """Training-step benchmark at the reference recipe (bs 16, 224 px
    crops, stage-2/3 model: learned skeleton + masked supervision +
    Markov bias; configs/train/1shot_split1.py:13-26,135), built as the
    trainer builds it (train/loop.py build_train_modules) from the port's
    seeded init. Returns (ms/step, episodes/s)."""
    import torch

    from .. import config as C
    from ..api import resolve_device
    from ..models.convert import init_params
    from ..train.loop import (batch_to_tensors, build_train_modules,
                              make_train_step)

    dev = resolve_device(device)
    mcfg = C.replace(mcfg, masked_supervision=True)
    cfg = C.Config(model=mcfg, train=C.TrainConfig(batch_size=batch_size,
                                                   warmup_iters=10))
    bb_state, head_state = init_params(torch.Generator().manual_seed(0),
                                       mcfg)
    backbone, model, optimizer, sched = build_train_modules(
        cfg, dev, bb_state, head_state, 100)
    step = make_train_step(model, backbone, optimizer, sched, cfg)

    b, size = batch_size, mcfg.image_size
    batch = batch_to_tensors(train_batch(b, shots, size, mcfg.max_kpt,
                                         mcfg.heatmap_size), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(warmup):
        float(step(batch, gen, i)["loss"])
    # The steps chain through the parameters (step i reads step i-1's
    # update), so timing the chain and syncing ONCE at the end measures
    # the step's latency; the trainer reads its metrics only at its log
    # interval, so it pays no sync a step either.
    t0 = time.perf_counter()
    for i in range(iters):
        metrics = step(batch, gen, warmup + i)
    float(metrics["loss"])   # host sync on the final step's output
    dt = time.perf_counter() - t0
    ms_per_step = dt / iters * 1000.0
    return ms_per_step, b * iters / dt


def bench_eval(mcfg, groups: int = 34, iters: int = 10, warmup: int = 2,
               shots: int = 1, device="cuda") -> float:
    """Cached-eval throughput (img/s on the card) at the test-protocol
    shape."""
    import torch

    from .. import config as C
    from ..api import PoseEstimator, resolve_device, strict_fp32

    dev = resolve_device(device)
    est = PoseEstimator(C.Config(model=mcfg),
                        generator=torch.Generator().manual_seed(0),
                        device=dev)
    g, s, k = groups, shots, mcfg.max_kpt
    nq = g * QUERIES_PER_EPISODE
    support, query = eval_inputs(g, s, mcfg.image_size, k)

    # Predictions reach the host with a depth-2 pipeline, as
    # eval/runner.py's cached loop does: chunk i is dispatched, then
    # chunk i-1's predictions are pulled (that pull is the sync). The
    # inputs stay on the device.
    support = {kk: torch.as_tensor(v, device=dev) for kk, v in
               support.items()}
    query_dev = {kk: torch.as_tensor(v, device=dev) for kk, v in
                 query.items()}
    best_dt = float("inf")
    # the strict path (fp32, plain modules) with TF32 off, as
    # PoseEstimator runs it
    with strict_fp32() if est.strict else contextlib.nullcontext():
        for _ in range(warmup):
            pred, _ = est.forward_cached(support, query_dev)
            pred.cpu()
        base_img = query_dev["img_q"]
        for _ in range(2):  # two timing loops; first can absorb stragglers
            t0 = time.perf_counter()
            prev = None
            for i in range(iters):
                query_dev["img_q"] = base_img + i * 1e-3
                pred, _ = est.forward_cached(support, query_dev)
                if prev is not None:
                    prev.cpu()
                prev = pred
            prev.cpu()
            best_dt = min(best_dt, time.perf_counter() - t0)
    return nq * iters / best_dt


def bench_disk_eval(mcfg, *, num_classes: int = 10,
                    images_per_class: int = 20, num_episodes: int = 6,
                    batch_size: int = 240, device="cuda") -> dict:
    """Disk-to-metrics pipeline: the synthetic MP-100 stand-in written to
    a temporary directory -> the cli.test path (image decode, warp,
    collate on the loader's worker thread, device eval, metrics) ->
    run_eval's result dict (images_per_sec and the host-vs-device
    seconds)."""
    import torch

    from .. import config as C
    from ..api import PoseEstimator, resolve_device
    from ..data import synthetic
    from ..data.mp100 import MP100Dataset
    from ..eval.runner import run_eval

    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="edgecape_bench_disk_")
    try:
        ann = synthetic.generate(root, num_classes=num_classes,
                                 images_per_class=images_per_class, seed=0)
        dcfg = C.DataConfig(ann_file=ann,
                            img_prefix=os.path.join(root, "images"),
                            num_shots=1, num_queries=QUERIES_PER_EPISODE,
                            num_episodes=num_episodes)
        cfg = C.Config(model=mcfg, test_data=dcfg)
        ds = MP100Dataset(dcfg, mode="test")
        est = PoseEstimator(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
        res_dir = os.path.join(root, "res")
        os.makedirs(res_dir, exist_ok=True)
        return run_eval(ds, est, batch_size=batch_size, res_folder=res_dir,
                        cache_supports=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _model_cfg(dtype: str, use_flash: bool = True):
    """bench.py's recipes: use_flash=True is the shipped recipe (the
    kernels in the eval and the training step); use_flash=False with
    float32 is the strict-parity recipe (plain modules, no bf16)."""
    from ..config import ModelConfig
    return ModelConfig(learn_skeleton=True, attn_bias=True,
                       use_bias_attn_module=True, use_flash=use_flash,
                       compute_dtype=dtype, head_dtype=dtype)


def run_phase(phase: str, groups: int, iters: int, warmup: int,
              shots: int, device="cuda") -> dict:
    if phase == "eval":
        per_chip = bench_eval(_model_cfg("bfloat16"), groups=groups,
                              iters=iters, warmup=warmup, shots=shots,
                              device=device)
        return {
            "metric": "mp100_1shot_eval_images_per_sec_per_chip",
            "value": round(per_chip, 2),
            "unit": "images/sec/chip",
            "vs_baseline": round(per_chip / BASELINE_IMG_PER_SEC, 3),
        }
    if phase == "eval_fp32":
        # the strict-parity recipe's throughput, so that a regression
        # that only hits the fp32 eval path shows
        v = bench_eval(_model_cfg("float32", use_flash=False),
                       groups=groups, iters=max(iters // 2, 3),
                       warmup=warmup, shots=shots, device=device)
        return {"value_fp32": round(v, 2)}
    if phase == "eval5":
        v = bench_eval(_model_cfg("bfloat16"), groups=groups,
                       iters=max(iters // 2, 3), warmup=warmup, shots=5,
                       device=device)
        return {"value_5shot": round(v, 2)}
    if phase == "disk_eval":
        res = bench_disk_eval(_model_cfg("bfloat16"), device=device)
        # the host-vs-device attribution, so that a change of this key
        # can be blamed on the right side
        return {"value_disk": round(float(res["images_per_sec"]), 2),
                "value_disk_split": {
                    "host_collate_s": res.get("host_collate_seconds"),
                    "device_wait_s": res.get("device_wait_seconds"),
                    "dispatch_s": res.get("dispatch_seconds"),
                    "first_call_s": res.get("first_call_seconds"),
                    "wall_s": res.get("eval_seconds")}}
    if phase in ("train_fp32", "train_bf16"):
        # both dtypes: fp32 is the shipped parity recipe, bf16 the fast
        # opt-in (on the card both train the head in fp32 over the fused
        # bf16 trunk; compute_dtype picks the plain trunk's dtype)
        dt = "float32" if phase == "train_fp32" else "bfloat16"
        ms, eps = bench_train(_model_cfg(dt), iters=iters, shots=shots,
                              device=device)
        tag = "fp32" if dt == "float32" else "bf16"
        sh = "" if shots == 1 else f"_{shots}shot"
        return {f"train_ms_per_step_{tag}{sh}": round(ms, 2),
                f"train_episodes_per_sec_{tag}{sh}": round(eps, 2)}
    raise SystemExit(f"unknown phase {phase}")


# Substrings of a failed child's output that mean "the device was
# transiently unavailable or never came up", from the messages torch
# raises: CUDA's own initialisation, a device that is busy or not (yet)
# visible. An assertion or a shape error is not among them, nor is
# "Torch not compiled with CUDA enabled" (a CPU build stays one).
_RETRYABLE_MARKERS = (
    "CUDA driver initialization failed",
    "No CUDA GPUs are available",
    "CUDA-capable device(s) is/are busy or unavailable",
    "CUDA error: initialization error",
    "CUDA unknown error",
    "CUDA error: system not yet initialized",
)


def _run_child(argv, timeout_s: float):
    """Run one phase subprocess from the directory that holds the
    package; returns (rc, combined_output). rc=-9 on timeout (treated as
    retryable: a hung device initialisation looks exactly like this)."""
    try:
        proc = subprocess.run(argv, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, check=False,
                              timeout=timeout_s, cwd=_ROOT)
        return proc.returncode, proc.stdout.decode(errors="replace")
    except subprocess.TimeoutExpired as e:
        txt = (e.stdout or b"").decode(errors="replace")
        return -9, txt + f"\n[bench] child timed out after {timeout_s:.0f}s"


def _retryable(rc: int, output: str) -> bool:
    return rc == -9 or any(m in output for m in _RETRYABLE_MARKERS)


# Wall-clock budget: every child timeout and backoff sleep is clamped
# against one deadline computed at start, and _RESERVE_S is held back so
# that the final JSON line is printed while time remains.
_RESERVE_S = 15.0
_MIN_ATTEMPT_S = 20.0


def _remaining(deadline: Optional[float]) -> float:
    if deadline is None:
        return float("inf")
    return deadline - time.monotonic() - _RESERVE_S


def _attempts(argv, label: str, *, max_attempts: int, backoff_scale: float,
              timeout_s: float, deadline: Optional[float] = None):
    """Retry loop around one phase subprocess. Returns (json_dict | None,
    error_message | None). Child timeouts and backoff sleeps are clamped
    to the global deadline; once fewer than _MIN_ATTEMPT_S remain the
    phase is skipped so the caller can still print the final JSON. A
    successful child's launch counters are passed on to stderr."""
    err = None
    for attempt in range(1, max_attempts + 1):
        rem = _remaining(deadline)
        if rem < _MIN_ATTEMPT_S:
            return None, (err or "skipped: wall-clock budget exhausted")
        rc, output = _run_child(argv, min(timeout_s, rem))
        lines = [ln for ln in output.splitlines() if ln.startswith("{")]
        if rc == 0 and lines:
            try:
                res = json.loads(lines[-1])
            except ValueError:
                # a log line that happens to start with '{' must not
                # abort main(): the always-print contract holds
                err = f"rc=0 but unparseable JSON tail: {lines[-1][:300]}"
                print(f"[bench] phase {label} attempt "
                      f"{attempt}/{max_attempts}: {err}", file=sys.stderr)
                break
            for ln in output.splitlines():
                if ln.startswith("[bench] launches "):
                    print(f"[bench] phase {label} launches "
                          f"{ln[len('[bench] launches '):]}",
                          file=sys.stderr, flush=True)
            return res, None
        err = (f"rc={rc}; tail: {output[-500:]}" if output
               else f"rc={rc}; no output")
        retryable = _retryable(rc, output)
        print(f"[bench] phase {label} attempt {attempt}/{max_attempts} "
              f"failed ({'device-init/timeout' if retryable else 'error'})"
              f"; rc={rc}", file=sys.stderr)
        print(output[-1500:], file=sys.stderr)
        if not retryable:
            break  # real failures (e.g. a bug) fail fast, no backoff
        if attempt < max_attempts:
            delay = 30.0 * (2 ** (attempt - 1)) * backoff_scale
            if delay >= _remaining(deadline):
                return None, err  # sleeping would eat the budget
            print(f"[bench] retrying {label} in {delay:.0f}s",
                  file=sys.stderr)
            time.sleep(delay)
    return None, err


def preflight(backoff_scale: float = 1.0, max_attempts: int = 3,
              timeout_s: float = 240.0, deadline: Optional[float] = None,
              device: str = "cuda") -> Optional[str]:
    """Cheap device probe (a tiny matmul in a subprocess with a hard
    timeout), so that a dead or hung device is diagnosed in one line
    before any long phase. Returns None if healthy, else the error."""
    code = ("import json,time; t0=time.time(); import torch;"
            f"d=torch.device({device!r});"
            "x=torch.ones((128,128),device=d); float((x@x).sum());"
            "c=d.type=='cuda';"
            "print(json.dumps({'device': torch.cuda.get_device_name(d) if c"
            " else 'cpu', 'devices': torch.cuda.device_count() if c else 1,"
            "'init_s': round(time.time()-t0,1)}))")
    argv = [sys.executable, "-c", code]
    res, err = _attempts(argv, "preflight", max_attempts=max_attempts,
                         backoff_scale=backoff_scale, timeout_s=timeout_s,
                         deadline=deadline)
    if res is not None:
        print(f"[bench] preflight ok: {json.dumps(res)}", file=sys.stderr)
        return None
    return err


def _switches() -> dict:
    """The kernel switches the phases run with: the port has one form of
    the encoder stack; the other two as ops/kernel_config.py resolves
    them (hopper_tuned.json unless overridden)."""
    from ..ops import kernel_config
    return {"encoder_stack": True,
            "decoder_stack": kernel_config.decoder_stack_default(),
            "vit_pair_blocks": kernel_config.vit_pair_blocks_default()}


def _emit(out: dict, errors: dict) -> None:
    """Print the cumulative result snapshot as one JSON line. Called after
    every completed phase: the last JSON line on stdout is the one to
    read, so an outer kill mid-run still leaves every phase measured so
    far on the record (the headline runs first)."""
    snap = dict(out)
    if errors:
        snap["errors"] = dict(errors)
    snap["kernel_switches"] = _switches()
    print(json.dumps(snap), flush=True)


def phase_specs(shots: int = 1, iters: int = 10, with_train: bool = True,
                with_5shot: bool = True, with_fp32: bool = True,
                with_disk: bool = True, only_phases=None) -> list:
    """[(phase, shots, iters)] in bench.py's order: headline first (the
    healthiest device window), secondary phases with fewer iterations,
    eval_fp32 last."""
    specs = [("eval", shots, iters)]
    if with_5shot and shots == 1:
        specs.append(("eval5", shots, iters))
    if with_disk:
        specs.append(("disk_eval", shots, iters))
    if with_train:
        specs += [("train_fp32", shots, iters), ("train_bf16", shots, iters)]
        if with_5shot and shots == 1:
            # the 5-shot train step (reference configs/train/5shot_split*)
            specs += [("train_fp32", 5, max(iters // 2, 4)),
                      ("train_bf16", 5, max(iters // 2, 4))]
    if with_fp32:
        specs.append(("eval_fp32", shots, iters))
    if only_phases:
        keep = set(only_phases)
        specs = [(p, s, i) for (p, s, i) in specs
                 if p in keep or f"{p}_{s}shot" in keep]
    return specs


def main(groups: int = 34, iters: int = 10, warmup: int = 2,
         shots: int = 1, with_train: bool = True, with_5shot: bool = True,
         with_fp32: bool = True, with_disk: bool = True,
         only_phases=None, max_attempts: int = 3,
         backoff_scale: float = 1.0, phase_timeout: float = 1500.0,
         budget_s: float = 2700.0, device: str = "cuda"):
    """Each phase runs in its own subprocess, so that no phase inherits
    another's allocations or device context. Preflight first, per-phase
    retries with exponential backoff (30/60/120 s) on device
    initialisation failures and timeouts, and the final JSON line is
    always printed (completed phases plus an "errors" key), all within
    one deadline (`budget_s`, <= 0 disables it). When the preflight
    never succeeds: DEGRADED mode, a single attempt of at most 120 s a
    phase; phases the budget cannot fit are recorded as skipped."""
    deadline = (time.monotonic() + budget_s) if budget_s > 0 else None
    specs = phase_specs(shots, iters, with_train, with_5shot, with_fp32,
                        with_disk, only_phases)

    out, errors = {}, {}

    # GNU timeout sends SIGTERM first: flush the snapshot before dying so
    # that whatever phases completed stay on the record
    def _on_term(signum, frame):
        errors["killed"] = f"signal {signum} mid-run; partial results"
        _emit(out, errors)
        sys.stdout.flush()
        os._exit(1)
    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # non-main thread / restricted env: snapshots still emit
    pf_err = preflight(backoff_scale=backoff_scale,
                       max_attempts=max_attempts, deadline=deadline,
                       device=device)
    if pf_err is not None:
        errors["preflight"] = pf_err
        max_attempts = 1
        phase_timeout = min(phase_timeout, 120.0)
        print("[bench] preflight NEVER succeeded; DEGRADED mode — one "
              f"<= {phase_timeout:.0f}s attempt per phase",
              file=sys.stderr)
    for phase, ph_shots, ph_iters in specs:
        label = phase if ph_shots == shots else f"{phase}_{ph_shots}shot"
        if _remaining(deadline) < _MIN_ATTEMPT_S:
            errors[label] = "skipped: wall-clock budget exhausted"
            continue
        argv = [sys.executable, "-m", MODULE,
                f"--phase={phase}", f"--groups={groups}",
                f"--iters={ph_iters}", f"--warmup={warmup}",
                f"--shots={ph_shots}", f"--device={device}"]
        res, err = _attempts(argv, label, max_attempts=max_attempts,
                             backoff_scale=backoff_scale,
                             timeout_s=phase_timeout, deadline=deadline)
        if res is not None:
            out.update(res)
        else:
            errors[label] = err
        _emit(out, errors)  # cumulative snapshot survives a later kill
    # always the last line, even on total failure (and for an empty phase
    # list, where the loop never emitted)
    _emit(out, errors)
    if not out:
        sys.exit(2)   # nothing measured (but the JSON above still stands)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m " + MODULE,
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--groups", type=int, default=34)
    p.add_argument("--shots", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--phase", default=None,
                   help="run one phase in this process (a child)")
    p.add_argument("--phases", default=None,
                   help="comma list of phase labels to run (parent only)")
    p.add_argument("--max-attempts", type=int, default=3)
    p.add_argument("--backoff-scale", type=float, default=1.0,
                   help="0: no sleep between attempts")
    p.add_argument("--phase-timeout", type=float, default=1500.0)
    p.add_argument("--budget-s", type=float,
                   default=float(os.environ.get("BENCH_BUDGET_S", 2700.0)),
                   help="global wall-clock budget; <= 0 disables it")
    p.add_argument("--no-train", action="store_true")
    p.add_argument("--no-5shot", action="store_true")
    p.add_argument("--no-fp32", action="store_true")
    p.add_argument("--no-disk", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    if a.phase is not None:
        result = run_phase(a.phase, a.groups, a.iters, a.warmup, a.shots,
                           device=a.device)
        from edgecape_tpu_torch.ops.counters import launch_counts
        print("[bench] launches " + json.dumps(launch_counts()),
              file=sys.stderr, flush=True)
        print(json.dumps(result))
    else:
        main(groups=a.groups, shots=a.shots, iters=a.iters,
             warmup=a.warmup, with_train=not a.no_train,
             with_5shot=not a.no_5shot, with_fp32=not a.no_fp32,
             with_disk=not a.no_disk,
             only_phases=a.phases.split(",") if a.phases else None,
             max_attempts=a.max_attempts, backoff_scale=a.backoff_scale,
             phase_timeout=a.phase_timeout, budget_s=a.budget_s,
             device=a.device)
