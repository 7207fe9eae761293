"""Converts the reference's PyTorch checkpoints into the port's files;
counterpart of scripts/convert_checkpoint.py (there is no orbax step: the
port's checkpoints are torch files).

    # full reference EdgeCape checkpoint -> the port's checkpoint file
    # (OUT/head.pt, which `cli.test CONFIG OUT/head.pt` and
    # `cli.serve --checkpoint OUT/head.pt` load) and, when the checkpoint
    # holds the DINOv2 trunk, OUT/backbone.pt (for --backbone-ckpt)
    python -m edgecape_tpu_torch.tools.convert_checkpoint ref2torch \\
        edgecape.pth OUT --stage 3

    # torch-hub DINOv2 -> OUT/backbone.pt (for --backbone-ckpt)
    python -m edgecape_tpu_torch.tools.convert_checkpoint dinov2 \\
        dinov2_vits14.pth OUT

`--stage` is the curriculum stage the reference checkpoint was trained
at (it decides which modules exist: 1 base, 2 learned skeleton, 3 with
the Markov attention bias). Runs on the host; needs no card.
"""

from __future__ import annotations

import argparse
import os

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.tools.convert_checkpoint",
        description="Convert reference checkpoints into the port's files")
    p.add_argument("mode", choices=["ref2torch", "dinov2"])
    p.add_argument("src", help="torch .pth checkpoint")
    p.add_argument("out", help="output directory")
    p.add_argument("--stage", type=int, default=3, choices=[1, 2, 3],
                   help="curriculum stage of the reference checkpoint")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--trust-pickle", action="store_true",
                   help="load the source with torch.load(weights_only="
                   "False), for checkpoints whose metadata is more than "
                   "tensors and plain containers (runs the file's pickle: "
                   "only for files you trust)")
    return p.parse_args(argv)


def stage_model_config(stage: int, image_size: int):
    """The ModelConfig of a reference checkpoint's curriculum stage."""
    from ..config import Config, ModelConfig, stage2_config, stage3_config
    cfg = Config(model=ModelConfig(image_size=image_size))
    if stage >= 2:
        cfg = stage2_config(cfg)
    if stage >= 3:
        cfg = stage3_config(cfg)
    return cfg.model


def main(argv=None) -> dict:
    """Writes the converted files; returns {kind: path}."""
    args = parse_args(argv)
    from ..models import convert
    from ..train import checkpoint as ck

    sd = torch.load(args.src, map_location="cpu",
                    weights_only=not args.trust_pickle)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    os.makedirs(args.out, exist_ok=True)
    written = {}
    if args.mode == "dinov2":
        backbone = convert.convert_hub_state_dict(sd, args.image_size)
        head = None
    else:
        backbone, head = convert.convert_full(
            sd, stage_model_config(args.stage, args.image_size),
            image_size=args.image_size)
        written["head"] = os.path.join(args.out, "head.pt")
        ck.save_checkpoint(written["head"],
                           {"model": head, "epoch": -1, "best_pck": 0.0})
    if backbone is not None:
        written["backbone"] = os.path.join(args.out, "backbone.pt")
        ck.save_checkpoint(written["backbone"], backbone)
    for path in written.values():
        print("wrote", path)
    return written


if __name__ == "__main__":
    main()
