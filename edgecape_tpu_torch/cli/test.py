"""Evaluation CLI of the port; counterpart of test.py.

Config + checkpoint -> seeded episodic MP-100 evaluation:
PCK@{thresholds} / mPCK / NME / AUC / EPE, `result_keypoints.json` and one
line appended to `testing_log.txt` in the work directory.

    python -m edgecape_tpu_torch.cli.test CONFIG [CHECKPOINT] [--work-dir D]

Runs on the CUDA device and raises without one; `--device cpu` is the
only way onto the CPU. Multi-process (`--dist-coordinator`,
`--dist-num-processes`, `--dist-process-id`; cli/dist_flags.py): one
process per device, each evaluates its share of the episodes, the
records are gathered and only process 0 prints and writes files.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from . import dist_flags


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.cli.test",
        description="Evaluate EdgeCape (PyTorch + CUDA port)")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="checkpoint file of the port's trainer (omit for "
                   "random weights)")
    p.add_argument("--work-dir", dest="work_dir", default=None)
    p.add_argument("--batch-size", type=int, default=240)
    p.add_argument("--no-cache-supports", action="store_true",
                   help="disable per-episode support-context caching "
                   "(slower; the same metrics)")
    p.add_argument("--backbone-ckpt", default=None,
                   help="torch-hub DINOv2 .pth, or a backbone state dict "
                   "saved by this package")
    p.add_argument("--strict-parity", action="store_true",
                   help="fp32 eval through plain PyTorch (no hand-written "
                   "kernels, no bf16 casts, TF32 off): the mode for "
                   "bisecting a checkpoint's PCK against the JAX package")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="+", default=[])
    dist_flags.add_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    random.seed(0)
    np.random.seed(0)

    from .. import config as config_lib
    from ..api import PoseEstimator
    from ..config import Config
    from ..data.mp100 import MP100Dataset
    from ..eval.runner import append_testing_log, run_eval
    from ..models.convert import load_backbone
    from ..parallel import multihost
    from ..train import checkpoint as ck

    device = dist_flags.setup(args)
    cfg = Config.from_file(args.config).override(args.cfg_options)
    if args.strict_parity:
        cfg = config_lib.replace(cfg, model=config_lib.replace(
            cfg.model, use_flash=False, compute_dtype="float32",
            head_dtype="float32", train_backbone_fast=False))
    if args.work_dir:
        cfg = config_lib.replace(cfg, work_dir=args.work_dir)
    work_dir = cfg.work_dir
    os.makedirs(work_dir, exist_ok=True)

    ds = MP100Dataset(cfg.test_data, mode="test")

    head_state = None
    if args.checkpoint:
        tree = ck.load_checkpoint(args.checkpoint)
        head_state = tree.get("model", tree)
    backbone = load_backbone(args.backbone_ckpt, cfg.model.image_size)

    est = PoseEstimator(cfg, backbone, head_state, device=device)
    results = run_eval(ds, est, batch_size=args.batch_size,
                       res_folder=work_dir,
                       cache_supports=not args.no_cache_supports)
    if multihost.is_primary():
        for k, v in results.items():
            print(f"{k}: {v}")
    append_testing_log(work_dir, os.path.basename(args.config),
                       args.checkpoint or "<random>", results)
    return results


if __name__ == "__main__":
    main()
