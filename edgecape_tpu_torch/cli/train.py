"""Train CLI of the port; counterpart of train.py.

The same surface: argparse flags, deterministic seeding, auto-resume from
the work directory, linear learning-rate scaling by device count, config
dump into the work directory.

    python -m edgecape_tpu_torch.cli.train --config CONFIG [--work-dir D]

Runs on the CUDA device and raises without one; `--device cpu` is the
only way onto the CPU. Multi-process (`--dist-coordinator`,
`--dist-num-processes`, `--dist-process-id`; cli/dist_flags.py): one
process per device, data-parallel over the processes with the gradients
reduced every step (train/loop.py); only process 0 writes files.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from . import dist_flags


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.cli.train",
        description="Train EdgeCape (PyTorch + CUDA port)")
    p.add_argument("--config", required=True, help="config file (.py "
                   "exporting `config: edgecape_tpu_torch.config.Config`)")
    p.add_argument("--work-dir", "--work_dir", dest="work_dir", default=None)
    p.add_argument("--resume-from", dest="resume_from", default=None)
    p.add_argument("--load-from", dest="load_from", default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--backbone-ckpt", default=None,
                   help="torch-hub DINOv2 .pth (converted on the fly), or "
                   "a backbone state dict saved by this package")
    p.add_argument("--autoscale-lr", action="store_true",
                   help="linearly scale lr by #devices/8 (one device "
                   "per process)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="dotted overrides, e.g. model.learn_skeleton=true")
    dist_flags.add_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    random.seed(args.seed)
    np.random.seed(args.seed)

    from .. import config as config_lib
    from ..config import Config
    from ..data.compose import build_train_dataset
    from ..data.loader import Prefetcher
    from ..data.mp100 import MP100Dataset
    from ..models.convert import load_backbone
    from ..parallel import multihost
    from ..train.loop import Trainer

    device = dist_flags.setup(args)
    cfg = Config.from_file(args.config).override(args.cfg_options)
    if args.work_dir:
        cfg = config_lib.replace(cfg, work_dir=args.work_dir)
    if args.resume_from:
        cfg = config_lib.replace(cfg, resume_from=args.resume_from)
    if args.load_from:
        cfg = config_lib.replace(cfg, load_from=args.load_from)
    if args.autoscale_lr:
        n_dev = multihost.process_count()
        cfg = config_lib.replace(cfg, train=config_lib.replace(
            cfg.train, lr=cfg.train.lr * n_dev / 8.0))

    os.makedirs(cfg.work_dir, exist_ok=True)
    if multihost.is_primary():
        cfg.dump(os.path.join(cfg.work_dir, "config.json"))

    train_ds = build_train_dataset(cfg.train_data)
    val_ds = (MP100Dataset(cfg.val_data, mode="val")
              if cfg.val_data.ann_file else None)
    backbone = load_backbone(args.backbone_ckpt, cfg.model.image_size)
    if backbone is None:
        print("WARNING: no --backbone-ckpt given; using randomly "
              "initialized DINOv2 weights")

    trainer = Trainer(cfg, train_ds, Prefetcher, val_ds,
                      backbone_state=backbone, device=device)
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
