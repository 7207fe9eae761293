"""Synthetic MP-100 stand-in experiment (no real data needed): generates
the dataset on first use under $SYNTH_ROOT (default: `mp100_synth_torch`
in the system's temporary directory) and runs the full pipeline at reduced
resolution. For driving the train / test CLIs end to end; counterpart of
configs/synthetic.py."""
import os
import tempfile

from edgecape_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                       TrainConfig)
from edgecape_tpu_torch.data import synthetic

ROOT = os.environ.get("SYNTH_ROOT", os.path.join(tempfile.gettempdir(),
                                                 "mp100_synth_torch"))
ann = os.path.join(ROOT, "annotations", "mp100_synth.json")
if not os.path.exists(ann):
    ann = synthetic.generate(ROOT, num_classes=6, images_per_class=12,
                             image_size=256, seed=0)

_data = DataConfig(ann_file=ann, img_prefix=os.path.join(ROOT, "images"),
                   num_shots=1, num_queries=3, num_episodes=2,
                   image_size=112, heatmap_size=32, max_kpt=16, sigma=1.0)
config = Config(
    model=ModelConfig(image_size=112, heatmap_size=32, max_kpt=16),
    train_data=_data, val_data=_data, test_data=_data,
    train=TrainConfig(total_epochs=2, batch_size=4, warmup_iters=10,
                      eval_interval=1, ckpt_interval=1, log_interval=5),
    work_dir="work_dirs/synthetic")
