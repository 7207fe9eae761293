"""The port's command lines (python -m edgecape_tpu_torch.cli.test / .train /
.run) on the CPU at a small size, on the port's synthetic config: the
slice as a whole, from files on disk to metrics.

Each CLI's `main` is called with an argv and `--device cpu`. Its numbers
are held against the port's `run_eval` / `Trainer` fed the JAX package's
`MP100Dataset` and `Prefetcher` on the same files with the same seeds.
Bounds: the training loader of both packages warps through a C++ core of
the same arithmetic, so the epoch's mean losses agree to 1e-4; the eval
loop of the JAX package's dataset warps with cv2 (fixed-point bilinear,
up to 4/255 per pixel), which moves predictions of a random-weight model a
little: PCK within 0.03, NME and AUC within 2% relative."""

import glob
import json
import os
import random

import numpy as np
import pytest
import torch

import torch_threads  # caps torch's threads per worker; the CLIs' limits
from edgecape_tpu import config as jcfg
from edgecape_tpu.data import loader as jloader
from edgecape_tpu.data import mp100 as jmp
from edgecape_tpu_torch import config as tcfg
from edgecape_tpu_torch.api import PoseEstimator
from edgecape_tpu_torch.cli import run as cli_run
from edgecape_tpu_torch.cli import test as cli_test
from edgecape_tpu_torch.cli import train as cli_train
from edgecape_tpu_torch.eval.runner import run_eval
from edgecape_tpu_torch.train import checkpoint as ck
from edgecape_tpu_torch.train.loop import Trainer
from edgecape_tpu_torch.utils.tb_writer import read_scalars

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "edgecape_tpu_torch", "configs", "synthetic.py")
# one epoch of 3 steps of batch 24 over the 72 class-balanced pairs
SMALL = ["train.total_epochs=1", "train.batch_size=24",
         "train.num_workers=2", "train.log_interval=1"]
# seconds a CLI call may take (torch_threads.within): a few times the
# longest here, cli.run's curriculum (about 48 s), and cli.train / cli.test
# (up to about 13 s)
CURRICULUM_TIMEOUT, CLI_TIMEOUT = 240, 120


def _main(cli, argv, timeout=CLI_TIMEOUT):
    """cli.main(argv) within its limit."""
    return torch_threads.within(lambda: cli.main(argv),
                                f"{cli.__name__}.main", timeout)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synthetic config's data root, generated once."""
    root = str(tmp_path_factory.mktemp("mp100_synth"))
    old = os.environ.get("SYNTH_ROOT")
    os.environ["SYNTH_ROOT"] = root
    tcfg.Config.from_file(CONFIG)            # generates on first load
    yield root
    if old is None:
        os.environ.pop("SYNTH_ROOT", None)
    else:
        os.environ["SYNTH_ROOT"] = old


def _jax_data_cfg(d):
    return jcfg.DataConfig(**{f.name: getattr(d, f.name) for f in
                              __import__("dataclasses").fields(d)})


@pytest.fixture(scope="module")
def trained(synth, tmp_path_factory):
    """cli.train on the CPU: (work dir, the trainer it returns)."""
    work = str(tmp_path_factory.mktemp("train"))
    trainer = _main(cli_train, ["--config", CONFIG, "--work-dir", work,
                                "--device", "cpu", "--seed", "3",
                                "--cfg-options"] + SMALL)
    return work, trainer


@pytest.mark.parametrize("cli", [cli_test, cli_train, cli_run])
def test_help_exits_cleanly(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device" in out and "--cfg-options" in out
    assert "--dist-coordinator" in out and "--dist-process-id" in out


@pytest.mark.parametrize("cli,argv", [
    (cli_test, [CONFIG]),
    (cli_train, ["--config", CONFIG]),
    (cli_run, ["--config", CONFIG, "--work_dir", "unused"])])
def test_clis_default_to_the_card_and_raise_without_one(synth, cli, argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)


def test_cli_train_leaves_the_work_dir_layout(trained):
    work, trainer = trained
    assert trainer.step == 3 and trainer.device.type == "cpu"
    for name in ("config.json", "train_log.jsonl", "latest.json", "epoch_1",
                 "epoch_1.meta.json", "best_PCK_epoch_1",
                 "result_keypoints.json"):
        assert os.path.exists(os.path.join(work, name)), name
    cfg = json.load(open(os.path.join(work, "config.json")))
    assert cfg["work_dir"] == work and cfg["train"]["batch_size"] == 24
    events = glob.glob(os.path.join(work, "tf_logs", "events.*"))
    assert len(events) == 1
    scalars = read_scalars(events[0])
    tags = {t for t, _, _ in scalars}
    assert {"train/loss", "train/lr", "val/PCK"} <= tags
    assert all(np.isfinite(v) for _, v, _ in scalars)
    entry = json.loads(open(os.path.join(work, "train_log.jsonl")).read())
    assert np.isfinite(entry["train_loss"]) and 0 <= entry["val_pck"] <= 1
    assert ck.latest_checkpoint(work).endswith("epoch_1")


def test_cli_train_matches_trainer_on_the_jax_loader(trained, synth,
                                                     tmp_path):
    """The same seeds, files and configuration through the port's Trainer
    fed the JAX package's dataset and Prefetcher."""
    work, _ = trained
    cfg = tcfg.Config.from_file(CONFIG).override(SMALL)
    cfg = tcfg.replace(cfg, work_dir=str(tmp_path))
    random.seed(3)
    np.random.seed(3)
    train_ds = jmp.MP100Dataset(_jax_data_cfg(cfg.train_data), mode="train")
    val_ds = jmp.MP100Dataset(_jax_data_cfg(cfg.val_data), mode="val")

    def jax_loader(ds, bs, **kw):
        return jloader.Prefetcher(ds, bs, use_native=True, **kw)

    Trainer(cfg, train_ds, jax_loader, val_ds, device="cpu",
            log_fn=lambda *a: None).fit()
    got = json.loads(open(os.path.join(work, "train_log.jsonl")).read())
    want = json.loads(open(tmp_path / "train_log.jsonl").read())
    assert set(got) == set(want)
    for k in want:
        if k.startswith("train_") or k == "lr":
            assert got[k] == pytest.approx(want[k], abs=1e-4), k
    # the eval hook of the JAX dataset warps with cv2
    assert got["val_pck"] == pytest.approx(want["val_pck"], abs=0.03)


def test_cli_test_matches_run_eval_on_the_jax_dataset(trained, synth,
                                                      tmp_path):
    work, _ = trained
    ckpt = os.path.join(work, "epoch_1")
    res = _main(cli_test, [CONFIG, ckpt, "--work-dir",
                           str(tmp_path / "cli"), "--device", "cpu"])
    for name in ("result_keypoints.json", "testing_log.txt"):
        assert os.path.exists(tmp_path / "cli" / name)
    log = open(tmp_path / "cli" / "testing_log.txt").read()
    assert "config: synthetic.py" in log and ckpt in log and "PCK:" in log
    recs = json.load(open(tmp_path / "cli" / "result_keypoints.json"))
    assert len(recs) == 36 and [r["bbox_id"] for r in recs] == list(range(36))

    cfg = tcfg.Config.from_file(CONFIG)
    ds = jmp.MP100Dataset(_jax_data_cfg(cfg.test_data), mode="test")
    est = PoseEstimator(cfg, None, ck.load_checkpoint(ckpt)["model"],
                        device="cpu")
    ref = run_eval(ds, est, batch_size=240, res_folder=str(tmp_path / "ref"),
                   progress=False, cache_supports=True)
    for k in ("PCK", "mPCK", "PCK@0.05", "PCK@0.25"):
        assert res[k] == pytest.approx(ref[k], abs=0.03), k
    for k in ("NME", "AUC", "EPE"):
        assert res[k] == pytest.approx(ref[k], rel=0.02), k
    assert all(np.isfinite(v) for v in res.values())


def test_cli_test_flags(trained, synth, tmp_path):
    """--no-cache-supports gives the cached loop's metrics; --strict-parity
    is the fp32 plain path; random weights without a checkpoint."""
    work, _ = trained
    ckpt = os.path.join(work, "epoch_1")
    common = ["--device", "cpu", "--batch-size", "12"]
    cached = _main(cli_test, [CONFIG, ckpt, "--work-dir",
                              str(tmp_path / "a")] + common)
    uncached = _main(cli_test, [CONFIG, ckpt, "--work-dir",
                                str(tmp_path / "b"), "--no-cache-supports"]
                     + common)
    strict = _main(cli_test, [CONFIG, ckpt, "--work-dir",
                              str(tmp_path / "c"), "--strict-parity"]
                   + common)
    assert "host_collate_seconds" in cached
    assert "host_collate_seconds" not in uncached
    # fp32 on the CPU along two loops: the same keypoints to 1e-3 pixels
    for k in ("PCK", "mPCK", "NME", "AUC"):
        assert uncached[k] == pytest.approx(cached[k], abs=1e-3), k
        assert strict[k] == pytest.approx(cached[k], abs=1e-3), k
    rand = _main(cli_test, [CONFIG, "--work-dir", str(tmp_path / "d"),
                            "--cfg-options", "test_data.num_episodes=1"]
                 + common)
    assert "<random>" in open(tmp_path / "d" / "testing_log.txt").read()
    assert np.isfinite(rand["NME"])
    assert len(json.load(open(tmp_path / "d" / "result_keypoints.json"))) == 18


def test_cli_train_flags_resume_and_autoscale(trained, synth, tmp_path,
                                              capsys):
    work, _ = trained
    # auto-resume: the work dir's latest checkpoint is epoch 1 of 1
    again = _main(cli_train, ["--config", CONFIG, "--work-dir", work,
                              "--device", "cpu", "--cfg-options"] + SMALL)
    assert again.start_epoch == 1 and again.step == 3
    out = capsys.readouterr().out
    assert "resumed from" in out and "randomly initialized DINOv2" in out
    # warm start, lr scaled by devices / 8 (one device on the CPU), and a
    # backbone file of the port
    bb = str(tmp_path / "bb.pt")
    torch.save({"backbone": again.backbone_state}, bb)
    tr = _main(cli_train, ["--config", CONFIG, "--work-dir",
                           str(tmp_path / "w"), "--device", "cpu",
                           "--autoscale-lr", "--load-from",
                           os.path.join(work, "epoch_1"), "--backbone-ckpt",
                           bb, "--cfg-options"] + SMALL
               + ["train.total_epochs=0", "train.tensorboard=false"])
    assert tr.cfg.train.lr == pytest.approx(1e-5 / 8.0)
    assert "randomly initialized" not in capsys.readouterr().out
    assert all(torch.equal(tr.backbone_state[k], again.backbone_state[k])
               for k in tr.backbone_state)
    loaded = ck.load_checkpoint(os.path.join(work, "epoch_1"))["model"]
    assert all(torch.equal(v, loaded[k])
               for k, v in tr.model.state_dict().items())
    assert not os.path.exists(tmp_path / "w" / "tf_logs")


def test_cli_run_curriculum_artifacts(synth, tmp_path):
    work = str(tmp_path / "run")
    arts = _main(cli_run, ["--config", CONFIG, "--work_dir", work,
                           "--device", "cpu", "--ft_epochs", "1",
                           "--masking_ratio", "0.4", "--cfg-options"] + SMALL
                 + ["test_data.num_episodes=1"], CURRICULUM_TIMEOUT)
    for stage in ("base", "base_skeleton", "base_skeleton_bias"):
        assert arts[stage] == os.path.join(work, stage, "epoch_1")
        assert os.path.exists(arts[stage])
    for name in ("base_config.json", "skeleton_config.json",
                 "bias_config.json", "testing_log.txt"):
        assert os.path.exists(os.path.join(work, name)), name
    skel = json.load(open(os.path.join(work, "skeleton_config.json")))
    assert skel["model"]["learn_skeleton"] and \
        skel["model"]["masking_ratio"] == 0.4
    bias = json.load(open(os.path.join(work, "bias_config.json")))
    assert bias["model"]["attn_bias"] and \
        bias["model"]["model_freeze"] == "skeleton"
    assert bias["load_from"] == arts["base_skeleton"]
    assert set(arts["eval"]) == {"latest", "best"}
    assert all(np.isfinite(v) for v in arts["eval"]["latest"].values())
