"""Multi-process eval and training of the port (parallel/, eval/runner.py's
sharding and record gather, the trainer's gradient reduce, cli.test's
`--dist-*` flags) on the CPU with gloo, against one process.

The ranks are subprocesses that run this file (its `__main__`), two
threads of each kind apiece, meeting at a `file://` rendezvous in the
test's temporary directory (no ports). One job starts two ranks and, at
the same time, one process alone; each runs the same routine on a
synthetic MP-100 stand-in at 28 px in fp32 (a narrow head, a one-block
trunk, the full ViT-S/14 trunk in `cli.test`): cached and uncached
`run_eval`, a cached eval where rank 1 has no episode group, two `Trainer.fit` steps of the stage-2 model (dropout 0,
masked supervision, gradient clip on) with the threaded loader sharding
the global batch of 12, and `cli.test`; then the three processes form a
group of 3 and gather ~10k ragged records (tests/multiproc_driver.py's
plan; rank 0 writes what it got, the test builds the concatenation).
The one process and the two ranks of the step run the same port code;
that the one-process step and eval equal the JAX package's is held by
tests/test_torch_train.py (test_step_loss_dict_matches_jax and
test_step_gradients_match_jax, stage 2) and tests/test_torch_eval_paths.py
(test_uncached_run_eval_matches_jax), on other narrow widths. Bounds:
records of the same episodes carry the same bbox_ids and keypoints
within 1e-5 px and metrics within 1e-6 (the eval batches are 9 rows, so
that both runs see the same batches: the CPU's fp32 matmuls sum a row in
another order at another batch size, which moved keypoints by 1e-4 px
when the shards were cut into other batches than one process's); the reduced
gradients within 1e-6 + 1e-4 relative of one process's on the
concatenated batch, the key-projection biases (no gradient in exact
arithmetic) absolutely; the loss dict and acc_pose within 1e-5; the
parameters after the two steps bit-equal on both ranks; the gathered
records bit-equal to the concatenated ones after JSON.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300
SIZE, K = 28, 16
# the head's widths (the config file's); run_eval and the trainer take a
# one-block trunk of width 32, cli.test the full ViT-S/14
NARROW = dict(d_model=32, num_feats=16, similarity_proj_dim=32,
              dim_feedforward=48, dynamic_proj_dim=16, nhead=2)
TRUNK_WIDTH = dict(depth=1, embed_dim=32, num_heads=1)
# rows of an uncached batch and of a cached chunk (3 groups of 3 queries):
# a half of the 18 test episodes, so one process and two ranks see the
# same batches
EVAL_BATCH = 9
TIMING_KEYS = ("eval_seconds", "images_per_sec", "host_collate_seconds",
               "device_wait_seconds", "dispatch_seconds")

CONFIG = '''from edgecape_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                       TrainConfig)
_data = DataConfig(ann_file={ann!r}, img_prefix={img!r}, num_shots=1,
                   num_queries=3, num_episodes=2, image_size={size},
                   heatmap_size=8, max_kpt={k}, sigma=1.0)
config = Config(
    model=ModelConfig(image_size={size}, heatmap_size=8, max_kpt={k},
                      dropout=0.0, **{narrow!r}),
    train_data=_data, val_data=_data, test_data=_data,
    train=TrainConfig(total_epochs=1, batch_size=12, warmup_iters=2,
                      eval_interval=1, ckpt_interval=1, log_interval=1,
                      num_workers=1, tensorboard=False, grad_clip=0.5),
    work_dir="work_dirs/dist")
'''


# --------------------------------------------------------------- the ranks
def _strip(res):
    return {k: v for k, v in res.items() if k not in TIMING_KEYS}


def rank_main(args):
    """One rank (or the process alone, world 1) of the main job."""
    import random

    import torch

    from edgecape_tpu_torch import config as C
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.cli import test as cli_test
    from edgecape_tpu_torch.data.loader import Prefetcher
    from edgecape_tpu_torch.data.mp100 import MP100Dataset
    from edgecape_tpu_torch.eval.runner import run_eval
    from edgecape_tpu_torch.models.convert import (init_params,
                                                   redraw_zero_inits)
    from edgecape_tpu_torch.models.dinov2 import DinoV2Config
    from edgecape_tpu_torch.parallel import multihost
    from edgecape_tpu_torch.train import checkpoint as ck
    from edgecape_tpu_torch.train.loop import Trainer

    TRUNK = DinoV2Config(**TRUNK_WIDTH)
    rank, world = args.rank, args.world
    cpu = torch.device("cpu")
    dist = []
    if world > 1:
        multihost.initialize(args.init, world, rank, backend="gloo",
                             device=cpu)
        dist = ["--dist-coordinator", args.init, "--dist-num-processes",
                str(world), "--dist-process-id", str(rank)]
    out = {"rank": rank, "world": world, "count": multihost.process_count()}
    tag = f"w{world}r{rank}"
    cfg = C.Config.from_file(args.config)
    small = C.replace(cfg, model=C.replace(cfg.model,
                                           backbone_dim=TRUNK.embed_dim))

    ds = MP100Dataset(cfg.test_data, mode="test")
    est = PoseEstimator(small, device="cpu", backbone_cfg=TRUNK)
    for name, cached in (("cached", True), ("uncached", False)):
        res_dir = os.path.join(args.out, f"{name}_{tag}")
        out[name] = _strip(run_eval(ds, est, batch_size=EVAL_BATCH,
                                    res_folder=res_dir, progress=False,
                                    cache_supports=cached))
    # one episode group: with two ranks, rank 1 has none
    one_cfg = C.replace(cfg.test_data, num_episodes=1,
                        valid_class_ids=[ds.valid_class_ids[0]])
    one = MP100Dataset(one_cfg, mode="test")
    out["groups_one"] = len(one.support_groups())
    out["one_group"] = _strip(run_eval(
        one, est, batch_size=EVAL_BATCH, res_folder=os.path.join(
            args.out, f"one_{tag}"), progress=False, cache_supports=True))

    # two steps of the stage-2 model on a sharded global batch of 12
    random.seed(0)
    np.random.seed(0)
    tcfg = C.replace(C.stage2_config(small), work_dir=os.path.join(
        args.out, f"train_w{world}"))
    # warm start from seeded weights whose zero-initialised parts are
    # redrawn, so that every parameter's gradient is exercised
    gen = torch.Generator().manual_seed(3)
    _, head = init_params(gen, tcfg.model, TRUNK)
    redraw_zero_inits({}, head, gen)
    seeded = os.path.join(args.out, f"seeded_{tag}.pt")
    ck.save_checkpoint(seeded, {"model": head})
    tcfg = C.replace(tcfg, load_from=seeded)
    train_ds = MP100Dataset(tcfg.train_data, mode="train")
    val_ds = MP100Dataset(tcfg.val_data, mode="val")
    tr = Trainer(tcfg, train_ds, Prefetcher, val_ds, device="cpu",
                 log_fn=lambda *a: None, backbone_cfg=TRUNK)
    steps, grads = [], {}
    inner = tr._step_fn

    def spy(batch, generator, step):
        metrics = inner(batch, generator, step)
        steps.append({k: float(v) for k, v in metrics.items()})
        if step == 0:
            grads.update({n: p.grad.clone() for n, p in
                          tr.model.named_parameters() if p.grad is not None})
            out["rows_per_step"] = int(batch["img_q"].shape[0])
        return metrics

    tr._step_fn = spy
    tr.fit()
    out["steps"] = steps
    out["best_pck"] = tr.best_pck
    torch.save({"grads": grads, "params": tr.model.state_dict()},
               os.path.join(args.out, f"train_{tag}.pt"))
    del tr, est

    # the CLI with the --dist-* flags (random weights, seed 0)
    res = cli_test.main([args.config, "--work-dir", os.path.join(
        args.out, f"cli_w{world}"), "--device", "cpu", "--batch-size",
        str(EVAL_BATCH)]
        + dist)
    out["cli"] = _strip(res)
    with open(os.path.join(args.out, f"out_{tag}.json"), "w") as f:
        json.dump(out, f)
    multihost.shutdown()
    # then the job's three processes form a group of 3 for the gather
    gather(args.gather_init, rank if world > 1 else 2, 3, args.out)


def gather(init, rank, world, out):
    """One rank of the ragged gather: tests/multiproc_driver.py's records
    of this rank through the runner's gather; rank 0 writes what it got."""
    sys.path.insert(0, REPO)
    import torch
    from edgecape_tpu_torch.eval.runner import _allgather_records
    from edgecape_tpu_torch.parallel import multihost

    multihost.initialize(init, world, rank, backend="gloo",
                         device=torch.device("cpu"))

    got = _allgather_records(gather_records(rank))
    if rank == 0:
        with open(os.path.join(out, "gathered.json"), "w") as f:
            json.dump(got, f)
    multihost.shutdown()


def gather_records(pid):
    """Process pid's records of tests/multiproc_driver.py's gather plan."""
    from tests.multiproc_driver import large_gather_plan, large_gather_record
    n, k = large_gather_plan(pid)
    return [large_gather_record(pid, i, k) for i in range(n)]


def _parse(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--init", default=None)
    p.add_argument("--gather-init", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


# --------------------------------------------------------------- the tests
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env[var] = "2"
    return env


def _start(world, rank, out, config, gather_init, init=None):
    cmd = [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
           "--world", str(world), "--out", out, "--config", config,
           "--gather-init", gather_init]
    cmd += ["--init", init] if init else []
    log = open(os.path.join(out, f"log_w{world}r{rank}.txt"), "w")
    return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=log,
                            stderr=subprocess.STDOUT), log


def _wait(procs):
    """Waits for every process (each within RANK_TIMEOUT); kills the rest
    when one fails or times out. Returns the return codes."""
    rcs = []
    try:
        for proc, log in procs:
            try:
                rcs.append(proc.wait(timeout=RANK_TIMEOUT))
            except subprocess.TimeoutExpired:
                rcs.append("timeout")
            if rcs[-1] != 0:
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return rcs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Runs the job: 2 ranks and one process alone, which then form a
    group of 3 for the gather. Returns their output directory."""
    from edgecape_tpu_torch.data import synthetic
    base = tmp_path_factory.mktemp("dist")
    root = str(base / "data")
    ann = synthetic.generate(root, num_classes=3, images_per_class=8,
                             image_size=64, seed=0)
    config = str(base / "cfg.py")
    with open(config, "w") as f:
        f.write(CONFIG.format(ann=ann, img=os.path.join(root, "images"),
                              size=SIZE, k=K, narrow=NARROW))
    out = str(base / "out")
    os.makedirs(out)
    gather_init = "file://" + str(base / "rdv_gather")
    procs = [_start(2, r, out, config, gather_init,
                    init="file://" + str(base / "rdv_main"))
             for r in range(2)]
    procs.append(_start(1, 0, out, config, gather_init))
    rcs = _wait(procs)
    logs = ""
    if rcs != [0] * len(procs):
        for name in sorted(os.listdir(out)):
            if name.startswith("log_"):
                with open(os.path.join(out, name)) as f:
                    logs += f"--- {name}\n{f.read()[-3000:]}\n"
    assert rcs == [0] * len(procs), f"{rcs}\n{logs}"
    return out


def _outs(out):
    def load(tag):
        with open(os.path.join(out, f"out_{tag}.json")) as f:
            return json.load(f)
    return load("w2r0"), load("w2r1"), load("w1r0")


def _records(path):
    with open(os.path.join(path, "result_keypoints.json")) as f:
        return json.load(f)


def _same_records(a, b):
    assert [r["bbox_id"] for r in a] == [r["bbox_id"] for r in b]
    assert len(a) > 0
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(ra["keypoints"], rb["keypoints"],
                                   atol=1e-5, rtol=0)
        for key in ("center", "scale", "area", "score", "image_id"):
            assert ra[key] == rb[key], key


def _same_metrics(a, b):
    assert set(a) == set(b)
    for key in a:
        assert a[key] == pytest.approx(b[key], abs=1e-6), key


@pytest.mark.parametrize("name", ["cached", "uncached"])
def test_two_rank_eval_matches_one_process(jobs, name):
    r0, r1, solo = _outs(jobs)
    assert (r0["count"], r1["count"], solo["count"]) == (2, 2, 1)
    _same_records(_records(os.path.join(jobs, f"{name}_w2r0")),
                  _records(os.path.join(jobs, f"{name}_w1r0")))
    # only the primary writes the file; every rank has the same metrics
    assert not os.path.exists(os.path.join(jobs, f"{name}_w2r1",
                                           "result_keypoints.json"))
    assert r0[name] == r1[name]
    _same_metrics(r0[name], solo[name])


def test_rank_without_groups_joins_the_gather(jobs):
    r0, r1, solo = _outs(jobs)
    assert solo["groups_one"] == 1
    _same_records(_records(os.path.join(jobs, "one_w2r0")),
                  _records(os.path.join(jobs, "one_w1r0")))
    assert r0["one_group"] == r1["one_group"]
    _same_metrics(r0["one_group"], solo["one_group"])


def test_cli_test_dist_flags_match_one_process(jobs):
    r0, r1, solo = _outs(jobs)
    _same_records(_records(os.path.join(jobs, "cli_w2")),
                  _records(os.path.join(jobs, "cli_w1")))
    assert r0["cli"] == r1["cli"]
    _same_metrics(r0["cli"], solo["cli"])
    with open(os.path.join(jobs, "cli_w2", "testing_log.txt")) as f:
        assert len(f.read().splitlines()) == 1       # the primary's line


def test_two_rank_steps_match_one_process_on_the_batch(jobs):
    import torch
    r0, r1, solo = _outs(jobs)
    assert (r0["rows_per_step"], r1["rows_per_step"],
            solo["rows_per_step"]) == (6, 6, 12)
    assert len(solo["steps"]) == len(r0["steps"]) == 2
    for s0, s1, ss in zip(r0["steps"], r1["steps"], solo["steps"]):
        assert s0 == s1
        assert set(s0) == set(ss) and "adj_reconstruct_loss" in ss
        for key in ss:
            assert s0[key] == pytest.approx(ss[key], abs=1e-5), key
    g0 = torch.load(os.path.join(jobs, "train_w2r0.pt"))["grads"]
    g1 = torch.load(os.path.join(jobs, "train_w2r1.pt"))["grads"]
    gs = torch.load(os.path.join(jobs, "train_w1r0.pt"))["grads"]
    assert set(g0) == set(g1) == set(gs) and len(gs) > 50
    live = 0
    for name, want in gs.items():
        assert torch.equal(g0[name], g1[name]), name
        if "k_proj.bias" in name:
            assert (g0[name] - want).abs().max() <= 1e-6, name
            continue
        np.testing.assert_allclose(g0[name].numpy(), want.numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)
        live += int(want.abs().max() > 1e-8)
    # not zeros against zeros (the skeleton's refine layers get no
    # gradient in this step, on both sides)
    assert live >= 0.5 * len(gs), (live, len(gs))
    assert r0["best_pck"] == r1["best_pck"]
    assert r0["best_pck"] == pytest.approx(solo["best_pck"], abs=1e-6)


def test_parameters_after_two_steps_bit_equal_across_ranks(jobs):
    import torch
    p0 = torch.load(os.path.join(jobs, "train_w2r0.pt"))["params"]
    p1 = torch.load(os.path.join(jobs, "train_w2r1.pt"))["params"]
    assert set(p0) == set(p1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    # the primary alone wrote the checkpoint, and every rank resumed from
    # it would hold these parameters
    from edgecape_tpu_torch.train import checkpoint as ck
    saved = ck.load_checkpoint(os.path.join(jobs, "train_w2", "epoch_1"))
    assert all(torch.equal(saved["model"][k], p0[k]) for k in p0)
    with open(os.path.join(jobs, "train_w2", "train_log.jsonl")) as f:
        assert len(f.read().splitlines()) == 1


def test_three_rank_ragged_gather_is_bit_identical(jobs):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    with open(os.path.join(jobs, "gathered.json")) as f:
        got = json.load(f)
    want = json.loads(json.dumps([r for pid in range(3)
                                  for r in gather_records(pid)]))
    assert len(got) == len(want) > 10000
    assert json.dumps(got) == json.dumps(want)
    assert max(r["image_id"] for r in got) > 2 ** 32


# shard_range / pad_to_multiple against the JAX package's, over a grid of
# (n, processes, index)
GRID = [(n, p, i) for n in (0, 1, 5, 7, 16, 33) for p in (1, 2, 3, 4)
        for i in range(p)]


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_shard_range_matches_jax(monkeypatch, p):
    import jax
    from edgecape_tpu.parallel import multihost as jmh
    from edgecape_tpu_torch.parallel import multihost as tmh
    covered = {}
    for n, pp, i in GRID:
        if pp != p:
            continue
        monkeypatch.setattr(jax, "process_count", lambda: pp)
        monkeypatch.setattr(jax, "process_index", lambda: i)
        monkeypatch.setattr(tmh, "process_count", lambda: pp)
        monkeypatch.setattr(tmh, "process_index", lambda: i)
        assert tmh.shard_range(n) == jmh.shard_range(n), (n, pp, i)
        covered.setdefault(n, []).extend(tmh.shard_range(n))
    for n, rows in covered.items():
        assert sorted(rows) == list(range(n))


@pytest.mark.parametrize("shape,axis", [((5,), 0), ((7, 3), 0), ((4, 6), 1),
                                        ((8, 2, 2), 0)])
def test_pad_to_multiple_matches_jax(shape, axis):
    from edgecape_tpu.parallel.mesh import pad_to_multiple as jpad
    from edgecape_tpu_torch.parallel.mesh import pad_to_multiple as tpad
    arr = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    for multiple in (1, 2, 3, 4, 8):
        a, na = tpad(arr, multiple, axis)
        b, nb = jpad(arr, multiple, axis)
        assert na == nb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_one_process_is_the_identity():
    import torch
    from edgecape_tpu_torch.parallel import multihost
    assert multihost.process_count() == 1 and multihost.is_primary()
    multihost.initialize()                                # a no-op
    tree = {"a": np.arange(3), "b": [torch.ones(2)]}
    assert multihost.allgather(tree) is tree
    assert multihost.broadcast(tree) is tree
    assert multihost.allreduce_sum(tree["b"][0]) is tree["b"][0]
    assert multihost.shard_batch_global(tree) is tree
    assert multihost.replicate_global(tree) is tree
    host = multihost.to_host(tree)
    assert isinstance(host["b"][0], np.ndarray) and host["a"] is tree["a"]
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize("localhost:1", 2, 0, backend="nccl",
                             device=torch.device("cpu"))


@pytest.mark.parametrize("p", [2, 3, 4])
def test_shard_batch_global_gives_contiguous_row_blocks(monkeypatch, p):
    import torch
    from edgecape_tpu_torch.parallel import multihost
    batch = {"img": np.arange(12 * 2).reshape(12, 2),
             "rows": [torch.arange(12)]}
    blocks = []
    for i in range(p):
        monkeypatch.setattr(multihost, "process_count", lambda: p)
        monkeypatch.setattr(multihost, "process_index", lambda: i)
        blocks.append(multihost.shard_batch_global(batch))
    np.testing.assert_array_equal(
        np.concatenate([b["img"] for b in blocks]), batch["img"])
    assert torch.equal(torch.cat([b["rows"][0] for b in blocks]),
                       batch["rows"][0])
    assert {len(b["img"]) for b in blocks} == {12 // p}
    monkeypatch.setattr(multihost, "process_count", lambda: 5)
    with pytest.raises(AssertionError, match="not divisible"):
        multihost.shard_batch_global(batch)


if __name__ == "__main__":
    os.cpu_count = lambda: 2            # the loader's C++ core's threads
    _args = _parse(sys.argv[1:])
    import torch as _torch
    _torch.set_num_threads(2)
    rank_main(_args)
