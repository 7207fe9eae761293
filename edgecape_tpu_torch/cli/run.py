"""Full-pipeline CLI of the port: the 3-stage training curriculum and the
final evaluation; counterpart of run.py.

The same surface (--config / --work_dir / --best / --ft_epochs /
--masking_ratio / --lamda_masking) and artifact layout (base/,
base_skeleton/, base_skeleton_bias/, the dumped stage configs,
testing_log.txt), with the stages driven in one process.

    python -m edgecape_tpu_torch.cli.run --config CONFIG --work_dir D

Runs on the CUDA device and raises without one; `--device cpu` is the
only way onto the CPU. run.py meshes all local devices in one process;
the port reaches the same with one process per device through the
`--dist-*` flags (cli/dist_flags.py): every stage trains data-parallel
and the final evaluation is sharded and gathered.
"""

from __future__ import annotations

import argparse

from . import dist_flags


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.cli.run",
        description="Run the training pipeline (PyTorch + CUDA port)")
    p.add_argument("--config", required=True)
    p.add_argument("--work_dir", "--work-dir", dest="work_dir",
                   required=True)
    p.add_argument("--best", action="store_true",
                   help="warm-start each stage from the best (not latest) "
                   "checkpoint")
    p.add_argument("--ft_epochs", type=int, default=100)
    p.add_argument("--masking_ratio", type=float, default=0.5)
    p.add_argument("--lamda_masking", type=float, default=1.0)
    p.add_argument("--skip-base", action="store_true",
                   help="assume the base stage checkpoint already exists")
    p.add_argument("--backbone-ckpt", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--cfg-options", nargs="+", default=[])
    dist_flags.add_flags(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..config import Config
    from ..data.compose import build_train_dataset
    from ..data.loader import Prefetcher
    from ..data.mp100 import MP100Dataset
    from ..models.convert import load_backbone
    from ..train.curriculum import run_curriculum

    device = dist_flags.setup(args)
    cfg = Config.from_file(args.config).override(args.cfg_options)
    backbone = load_backbone(args.backbone_ckpt, cfg.model.image_size)
    train_ds = build_train_dataset(cfg.train_data)
    val_ds = (MP100Dataset(cfg.val_data, mode="val")
              if cfg.val_data.ann_file else None)
    test_ds = (MP100Dataset(cfg.test_data, mode="test")
               if cfg.test_data.ann_file else None)
    artifacts = run_curriculum(
        cfg, args.work_dir, train_ds, Prefetcher, val_ds, test_ds,
        best=args.best, ft_epochs=args.ft_epochs,
        masking_ratio=args.masking_ratio, lamda_masking=args.lamda_masking,
        backbone_state=backbone, skip_base=args.skip_base, device=device)
    for k, v in artifacts.items():
        print(k, ":", v)
    return artifacts


if __name__ == "__main__":
    main()
