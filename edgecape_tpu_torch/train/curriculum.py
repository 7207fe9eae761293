"""The three-stage curriculum; counterpart of
edgecape_tpu/train/curriculum.py.

Stage 1 'base' (ground-truth skeleton only), stage 2 'base_skeleton'
(learned skeleton, masked supervision), stage 3 'base_skeleton_bias'
(attention bias, skeleton frozen), each warm-started from the previous
stage's final (or best) checkpoint, then an evaluation of the last
stage's latest and best checkpoints. Same artifact layout as the JAX
package (base/, base_skeleton/, base_skeleton_bias/, dumped stage
configs). The datasets and the loader factory are passed in as objects.
"""

from __future__ import annotations

import os
from typing import Optional

from .. import config as config_lib
from ..config import stage2_config, stage3_config
from ..models import dinov2
from . import checkpoint as ck
from .loop import Trainer

STAGES = ("base", "base_skeleton", "base_skeleton_bias")
STAGE_CONFIG_FILES = {"base": "base_config.json",
                      "base_skeleton": "skeleton_config.json",
                      "base_skeleton_bias": "bias_config.json"}


def _stage_cfg(cfg, stage: str, work_dir: str, load_from: Optional[str],
               ft_epochs: int, masking_ratio: float, lamda_masking: float):
    if stage == "base":
        out = cfg
    elif stage == "base_skeleton":
        out = stage2_config(cfg, masking_ratio, lamda_masking)
    elif stage == "base_skeleton_bias":
        out = stage3_config(cfg)
    else:
        raise ValueError(stage)
    if stage != "base":
        out = config_lib.replace(out, train=config_lib.replace(
            out.train, total_epochs=ft_epochs))
    return config_lib.replace(out, work_dir=work_dir, load_from=load_from,
                              resume_from=None)


def run_curriculum(cfg, work_dir: str, train_ds, loader_factory,
                   val_ds=None, test_ds=None, *, best: bool = False,
                   ft_epochs: int = 100, masking_ratio: float = 0.5,
                   lamda_masking: float = 1.0, backbone_state=None,
                   skip_base: bool = False, device="cuda",
                   log_fn=print,
                   backbone_cfg: dinov2.DinoV2Config = dinov2.VIT_S14
                   ) -> dict:
    """Trains the three stages on `train_ds` (eval hook on `val_ds`) and
    evaluates the last stage's latest and best checkpoints on `test_ds`.
    Returns {stage: final checkpoint path} plus 'eval' results. Runs on
    the CUDA device unless `device` says otherwise."""
    os.makedirs(work_dir, exist_ok=True)
    artifacts = {}
    prev_ckpt = None
    stage_dirs = {s: os.path.join(work_dir, s) for s in STAGES}

    for stage in STAGES:
        sdir = stage_dirs[stage]
        if stage == "base" and skip_base:
            # the base checkpoint must already be there
            prev_ckpt = ck.latest_checkpoint(sdir)
            artifacts[stage] = prev_ckpt
            continue
        scfg = _stage_cfg(cfg, stage, sdir, prev_ckpt, ft_epochs,
                          masking_ratio, lamda_masking)
        config_lib.dump(scfg, os.path.join(work_dir,
                                           STAGE_CONFIG_FILES[stage]))
        log_fn(f"=== curriculum stage: {stage} ===")
        trainer = Trainer(scfg, train_ds, loader_factory, val_ds,
                          backbone_state=backbone_state, device=device,
                          log_fn=log_fn, backbone_cfg=backbone_cfg)
        backbone_state = trainer.backbone_state
        trainer.fit()
        prev_ckpt = (ck.best_checkpoint(sdir) if best
                     else ck.latest_checkpoint(sdir))
        artifacts[stage] = prev_ckpt

    # final evaluation on latest + best of the last stage
    if test_ds is not None:
        from ..api import PoseEstimator
        from ..eval.runner import append_testing_log, run_eval
        final_dir = stage_dirs["base_skeleton_bias"]
        test_cfg = stage3_config(cfg)
        evals = {}
        for name, path in [("latest", ck.latest_checkpoint(final_dir)),
                           ("best", ck.best_checkpoint(final_dir))]:
            if path is None:
                continue
            tree = ck.load_checkpoint(path)
            est = PoseEstimator(test_cfg, backbone_state, tree["model"],
                                device=device, backbone_cfg=backbone_cfg)
            res = run_eval(test_ds, est, batch_size=cfg.train.batch_size,
                           res_folder=final_dir)
            append_testing_log(work_dir, "bias_config.json", path, res)
            evals[name] = res
        artifacts["eval"] = evals
    return artifacts
