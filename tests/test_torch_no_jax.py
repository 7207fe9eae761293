"""The port runs where jax, flax, optax, orbax and cv2 are absent (the
machine with the card has none of them): a fresh interpreter with those
modules blocked imports every module of edgecape_tpu_torch (the training
modules included), checks that none of them pulled in the JAX package,
and runs a tiny cached forward and two training steps of the trainer on
the CPU, on both the strict and the kernel-op path; a second interpreter
does the same for the variant switches, the uncached and debug forwards,
the bench tool's chains and the chip smoke's module; a third drives the
disk path: the synthetic stand-in, every config of the port's grid, the
loader, `cli.train`, `cli.test`, `cli.run --help`, the server on a PPM
request, the demo's inference and the probe tool on the CPU; and two
more, two ranks of a gloo process group, evaluate an in-memory episode
set sharded and gathered."""

import os
import subprocess
import sys

import torch_threads  # caps torch's threads per worker; child limits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "flax", "optax", "orbax", "cv2")
for m in BLOCKED:
    sys.modules[m] = None
import numpy as np
import torch
import edgecape_tpu_torch
names = [m.name for m in pkgutil.walk_packages(edgecape_tpu_torch.__path__,
                                               "edgecape_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for needed in ("config", "train.state", "train.loop", "train.checkpoint",
               "train.curriculum", "ops.kernel_config", "ops.fused_mlp",
               "ops.fused_attn_block", "tools.bench_attn_variants",
               "ops.mm_chain", "ops.warp", "ops.affine", "ops.heatmap",
               "tools.probe_m_fold", "data.coco", "data.pipeline",
               "data.native", "data.mp100", "data.compose", "data.loader",
               "data.synthetic", "eval.metrics", "utils.tb_writer",
               "models.convert", "configs._base", "cli.test", "cli.train",
               "cli.run", "cli.serve", "cli.router", "cli.demo", "cli.app",
               "utils.visualization", "parallel.mesh", "parallel.multihost",
               "utils.profiling", "tools.convert_checkpoint",
               "tools.profile_eval_stages", "cli.dist_flags", "tools.bench",
               "ops.counters"):
    assert "edgecape_tpu_torch." + needed in names, needed
pulled = [m for m in sys.modules if m.split(".")[0] == "edgecape_tpu"]
assert not pulled, pulled
from edgecape_tpu.config import Config, ModelConfig, stage3_config
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.models.dinov2 import DinoV2Config
from edgecape_tpu_torch.train.loop import Trainer
k, size, g = 6, 28, 2
trunk = DinoV2Config(depth=1, embed_dim=32, num_heads=1)


class Episodes:
    # a dataset that is its own loader, in memory
    num_shots = 1

    def __len__(self):
        return 4

    def resample_episodes(self):
        pass

    def epoch(self):
        rng = np.random.default_rng(1)
        f32 = np.float32
        for _ in range(2):
            yield {"img_s": rng.normal(size=(2, 1, size, size, 3)).astype(f32),
                   "img_q": rng.normal(size=(2, size, size, 3)).astype(f32),
                   "joints_s": rng.uniform(2, size - 2, (2, 1, k, 2)).astype(f32),
                   "vis_s": np.ones((2, 1, k), f32),
                   "target_q": np.zeros((2, k, 8, 8), f32),
                   "weight_q": np.ones((2, k), f32),
                   "joints_q": rng.uniform(2, size - 2, (2, k, 2)).astype(f32),
                   "binary_adj": np.ones((2, k, k), f32),
                   "rand_mask": (rng.uniform(size=(2, k)) > 0.5).astype(f32)}

for flash, dt in ((False, "float32"), (True, "bfloat16")):
    cfg = stage3_config(Config(model=ModelConfig(
        max_kpt=k, image_size=size, heatmap_size=8, backbone_dim=32,
        d_model=32, num_feats=16, similarity_proj_dim=32, dim_feedforward=48,
        dynamic_proj_dim=16, nhead=2, use_flash=flash, compute_dtype=dt,
        head_dtype=dt)))
    est = PoseEstimator(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu", backbone_cfg=trunk)
    rng = np.random.default_rng(0)
    support = {"img_s": rng.integers(0, 256, (g, 1, size, size, 3),
                                     dtype=np.uint8),
               "joints_s": rng.uniform(2, size - 2, (g, 1, k, 2)).astype(
                   np.float32),
               "vis_s": np.ones((g, 1, k), np.float32),
               "binary_adj": np.ones((g, k, k), np.float32)}
    query = {"img_q": rng.integers(0, 256, (4, size, size, 3),
                                   dtype=np.uint8),
             "group": np.array([0, 0, 1, 1])}
    pred, adj = est.forward_cached(support, query)
    assert pred.shape == (4, k, 2) and torch.isfinite(pred).all()
    import dataclasses, tempfile
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = dataclasses.replace(
            cfg, work_dir=tmp, train=dataclasses.replace(
                cfg.train, batch_size=2, total_epochs=1, log_interval=1))
        data = Episodes()
        tr = Trainer(tcfg, data, lambda ds, bs, **kw: ds, device="cpu",
                     log_fn=lambda *a: None, backbone_cfg=trunk)
        tr.fit()
        assert tr.step == 2
blocked = [m for m in BLOCKED if sys.modules.get(m) is not None]
assert not blocked, blocked
print("OK", len(names))
"""


# The test suite runs several of these interpreters at once. Each would
# take every core for torch's thread pool, and the loader's C++ core
# `os.cpu_count()` more, so together they would time out: a child gets two
# threads of each kind.
FEW_THREADS = "import os\nos.cpu_count = lambda: 2\n"


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        env[var] = "2"
    return env


def test_port_imports_and_runs_without_jax_flax_optax_cv2():
    env = _child_env()
    proc = torch_threads.run_child(
        [sys.executable, "-c", FEW_THREADS + SCRIPT], "the no-jax interpreter", cwd=REPO,
        env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")


VARIANT_SCRIPT = r"""
import importlib, sys, types
BLOCKED = ("jax", "flax", "optax", "orbax", "cv2")
for m in BLOCKED:
    sys.modules[m] = None
import numpy as np
import torch
for name in ("ops.kernel_config", "ops.fused_mlp", "ops.fused_attn_block",
             "ops.fused_vit_block", "ops.fused_decoder",
             "tools.bench_attn_variants"):
    importlib.import_module("edgecape_tpu_torch." + name)
import chip_smoke                      # the smoke's module itself
from edgecape_tpu.config import Config, ModelConfig, stage3_config
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.models.dinov2 import DinoV2Config
from edgecape_tpu_torch.ops import kernel_config
from edgecape_tpu_torch.tools import bench_attn_variants as bench
k, size = 6, 28
trunk = DinoV2Config(depth=2, embed_dim=32, num_heads=1)
cfg = stage3_config(Config(model=ModelConfig(
    max_kpt=k, image_size=size, heatmap_size=8, backbone_dim=32, d_model=32,
    num_feats=16, similarity_proj_dim=32, dim_feedforward=48,
    dynamic_proj_dim=16, nhead=2, use_flash=True, compute_dtype="bfloat16",
    head_dtype="bfloat16")))
est = PoseEstimator(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu", backbone_cfg=trunk)
rng = np.random.default_rng(0)
f32 = np.float32
batch = types.SimpleNamespace(
    img_s=rng.normal(size=(3, 2, size, size, 3)).astype(f32),
    img_q=rng.normal(size=(3, size, size, 3)).astype(f32),
    target_s=rng.uniform(size=(3, 2, k, 8, 8)).astype(f32),
    weight_s=np.ones((3, 2, k), f32), binary_adj=np.ones((3, k, k), f32),
    meta={"query_center": np.full((3, 2), size / 2, f32),
          "query_scale": np.full((3, 2), size / 200.0, f32),
          "query_image_file": ["a", "b", "c"], "bbox_id": [0, 1, 2]})
kernel_config.set_decoder_stack(True)
kernel_config.set_vit_pair_blocks(True)
pred, adj, traj = est.forward_batch(batch)
assert pred.shape == (3, k, 2) and traj.shape == (4, 3, k, 2)
assert torch.isfinite(traj).all()
out = est.decode_batch(pred, batch)
assert out["preds"].shape == (3, k, 3)
pred, adj, sim, attn = est.forward_debug(batch)
assert sim.shape == (3, k, 2, 2) and attn.shape == (3, 3, k, 4)
p = bench.params(np.random.default_rng(1), c=32, device="cpu")
x = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(f32))
for which in bench.VARIANTS:
    assert torch.isfinite(bench.chain(which, x, p, layers=2, heads=2)).all()
pulled = [m for m in sys.modules if m.split(".")[0] == "edgecape_tpu"
          and m not in ("edgecape_tpu", "edgecape_tpu.config")]
assert not pulled, pulled
blocked = [m for m in BLOCKED if sys.modules.get(m) is not None]
assert not blocked, blocked
print("OK")
"""


def test_variant_and_uncached_paths_run_without_jax():
    env = _child_env()
    proc = torch_threads.run_child(
        [sys.executable, "-c", FEW_THREADS + VARIANT_SCRIPT], "the variant-path interpreter", cwd=REPO,
        env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().startswith("OK")


CLI_SCRIPT = r"""
import glob, os, sys, tempfile
BLOCKED = ("jax", "flax", "optax", "orbax", "cv2", "edgecape_tpu")
for m in BLOCKED:
    sys.modules[m] = None
import numpy as np
import torch
from edgecape_tpu_torch.cli import run as cli_run
from edgecape_tpu_torch.cli import test as cli_test
from edgecape_tpu_torch.cli import train as cli_train
from edgecape_tpu_torch.config import Config
from edgecape_tpu_torch.tools import probe_m_fold
root = os.path.join("edgecape_tpu_torch", "configs")
grid = sorted(glob.glob(os.path.join(root, "t*", "*.py")))
assert len(grid) == 20, grid
for path in grid:
    cfg = Config.from_file(path)
    assert cfg.model.max_kpt == 100 and cfg.train.batch_size == 16
with tempfile.TemporaryDirectory() as tmp:
    os.environ["SYNTH_ROOT"] = os.path.join(tmp, "data")
    synth = os.path.join(root, "synthetic.py")
    small = ["train.total_epochs=1", "train.batch_size=24",
             "train.num_workers=2", "val_data.num_episodes=1",
             "test_data.num_episodes=1"]
    work = os.path.join(tmp, "work")
    tr = cli_train.main(["--config", synth, "--work-dir", work, "--device",
                         "cpu", "--cfg-options"] + small)
    assert tr.step == 3 and glob.glob(os.path.join(work, "tf_logs", "*"))
    res = cli_test.main([synth, os.path.join(work, "epoch_1"), "--work-dir",
                         work, "--device", "cpu", "--cfg-options"] + small)
    assert np.isfinite(res["NME"]) and 0.0 <= res["PCK"] <= 1.0
    assert os.path.exists(os.path.join(work, "testing_log.txt"))
    try:
        cli_run.main(["--help"])
    except SystemExit as e:
        assert e.code == 0
import base64
from edgecape_tpu_torch.cli import demo as cli_demo
from edgecape_tpu_torch.cli import serve as cli_serve
rng = np.random.default_rng(0)
img = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
ppm = base64.b64encode(b"P6\n30 40\n255\n" + img.tobytes()).decode()
svc = cli_serve.PoseService(size=28, max_kpt=4, device="cpu")
cid = svc.register_support({"images": [ppm], "keypoints": [[3, 4], [20, 30]],
                            "skeleton": [[0, 1]]})
out = svc.predict({"context_id": cid, "image": ppm})
assert len(out["keypoints"]) == 2 and len(out["edge_weights"]) == 1
res = cli_demo.infer(svc.est, img, img, {"keypoints": [[3, 4], [20, 30]]})
assert res["pred_px"].shape == (2, 2) and np.isfinite(res["pred_px"]).all()
out = probe_m_fold.main(["--device", "cpu", "--case", "4,2,8,16,32,2",
                         "--iters", "1", "--runs", "1"])
assert out[0]["bitsame"]
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK")
"""


def test_disk_path_clis_and_probe_run_without_jax_and_cv2():
    env = _child_env()
    proc = torch_threads.run_child(
        [sys.executable, "-c", FEW_THREADS + CLI_SCRIPT], "the disk-path interpreter", cwd=REPO,
        env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


DIST_SCRIPT = r"""
import json, os, sys
BLOCKED = ("jax", "flax", "optax", "orbax", "cv2", "edgecape_tpu")
for m in BLOCKED:
    sys.modules[m] = None
import numpy as np
import torch
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                       stage3_config)
from edgecape_tpu_torch.eval.runner import run_eval
from edgecape_tpu_torch.models.dinov2 import DinoV2Config
from edgecape_tpu_torch.parallel import multihost
rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
multihost.initialize(init, world, rank, backend="gloo",
                     device=torch.device("cpu"))
k, size, queries = 6, 28, 2


class Episodes:
    # 3 episode groups of 2 queries in memory
    img_prefix = "."
    name2id = {}

    def __init__(self):
        rng = np.random.default_rng(0)
        self.cfg = DataConfig(image_size=size, max_kpt=k)
        self.db, self.paired_samples, self.groups = [], [], []
        for _ in range(3):
            base = len(self.db)
            for _ in range(1 + queries):
                self.db.append({
                    "joints_3d": np.concatenate(
                        [rng.uniform(2, size - 2, (k, 2)), np.zeros((k, 1))],
                        1).astype(np.float32),
                    "joints_3d_visible": np.ones((k, 3), np.float32),
                    "bbox": np.array([0, 0, size, size], np.float32),
                    "image": rng.integers(0, 256, (size, size, 3),
                                          dtype=np.uint8)})
            rows = []
            for q in range(queries):
                rows.append(len(self.paired_samples))
                self.paired_samples.append([base, base + 1 + q])
            self.groups.append(((base,), rows))

    def __len__(self):
        return len(self.paired_samples)

    def support_groups(self):
        return self.groups

    def collate_group(self, chunk):
        rows = [r for _, rs in chunk for r in rs]
        g = len(chunk)
        db = self.db
        support = {
            "img_s": np.stack([[db[s]["image"] for s in sids]
                               for sids, _ in chunk]),
            "joints_s": np.stack([[db[s]["joints_3d"][:, :2] for s in sids]
                                  for sids, _ in chunk]),
            "vis_s": np.ones((g, 1, k), np.float32),
            "binary_adj": np.ones((g, k, k), np.float32)}
        query = {"img_q": np.stack([db[self.paired_samples[r][-1]]["image"]
                                    for r in rows]),
                 "group": np.repeat(np.arange(g, dtype=np.int32), queries)}
        meta = {"query_image_file": [f"./q{r}.png" for r in rows],
                "query_center": np.full((len(rows), 2), size / 2,
                                        np.float32),
                "query_scale": np.full((len(rows), 2), size / 200.0,
                                       np.float32),
                "bbox_id": rows}
        return support, query, meta


cfg = stage3_config(Config(model=ModelConfig(
    max_kpt=k, image_size=size, heatmap_size=8, backbone_dim=32, d_model=32,
    num_feats=16, similarity_proj_dim=32, dim_feedforward=48,
    dynamic_proj_dim=16, nhead=2)))
est = PoseEstimator(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu",
                    backbone_cfg=DinoV2Config(depth=1, embed_dim=32,
                                              num_heads=1))
res = run_eval(Episodes(), est, batch_size=4, res_folder=out,
               progress=False, cache_supports=True)
written = os.path.exists(os.path.join(out, "result_keypoints.json"))
assert written == (rank == 0), (rank, written)
if rank == 0:
    recs = json.load(open(os.path.join(out, "result_keypoints.json")))
    assert [r["bbox_id"] for r in recs] == list(range(6))
assert np.isfinite(res["NME"]) and 0.0 <= res["PCK"] <= 1.0
multihost.shutdown()
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK", res["PCK"], res["NME"])
"""


def test_two_rank_gloo_eval_runs_without_jax(tmp_path):
    env = _child_env()
    procs = []
    for rank in range(2):
        out = tmp_path / f"r{rank}"
        out.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", FEW_THREADS + DIST_SCRIPT, str(rank), "2",
             "file://" + str(tmp_path / "rdv"), str(out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = torch_threads.wait_children(
        [(f"gloo rank {rank}", proc, None) for rank, proc in enumerate(procs)])
    for rc, stdout, stderr in done:
        assert rc == 0, stdout + stderr
    assert len(done) == len(procs)
    lines = [stdout.strip().splitlines()[-1] for _, stdout, _ in done]
    assert lines[0].startswith("OK") and lines[0] == lines[1]
