"""Shared config functions of the port's MP-100 experiment grid;
counterpart of configs/_base.py, field for field.

One file per experiment: configs/{train,test}/{1,5}shot_split{1..5}.py. The
data root can be overridden with the MP100_ROOT environment variable.
"""

from __future__ import annotations

import os

from ..config import (Config, DataConfig, ModelConfig, TrainConfig,
                      stage3_config)

DATA_ROOT = os.environ.get("MP100_ROOT", "data/mp100")


def _data(split: int, part: str, shots: int, *, num_queries=15,
          num_episodes=100) -> DataConfig:
    return DataConfig(
        ann_file=f"{DATA_ROOT}/annotations/mp100_split{split}_{part}.json",
        img_prefix=f"{DATA_ROOT}/images/",
        num_shots=shots, num_queries=num_queries,
        num_episodes=num_episodes, image_size=224, heatmap_size=64,
        max_kpt=100, sigma=1.0)


def train_config(split: int, shots: int) -> Config:
    """Stage-1 base recipe: Adam 1e-5, warmup 1000, step [160, 180],
    100 epochs, batch 16."""
    return Config(
        # use_flash: the hand-written attention kernels in the head (the
        # differentiable one in training, the fused self-attention in the
        # uncached eval). On CPU tensors the ops take their plain versions.
        model=ModelConfig(use_flash=True),
        train_data=_data(split, "train", shots),
        val_data=_data(split, "val", shots, num_queries=15,
                       num_episodes=100),
        test_data=_data(split, "test", shots, num_queries=15,
                        num_episodes=200),
        train=TrainConfig(total_epochs=100, lr=1e-5, warmup_iters=1000,
                          warmup_ratio=1e-3, lr_step=(160, 180),
                          batch_size=16, eval_interval=25,
                          ckpt_interval=20),
        work_dir=f"work_dirs/{shots}shot_split{split}")


def test_config(split: int, shots: int) -> Config:
    """Final-model eval recipe: the stage-3 flags (learned skeleton +
    attention bias) baked in."""
    return stage3_config(train_config(split, shots))
