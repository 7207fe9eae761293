"""Configuration of the port: typed dataclasses, a file per experiment
(python files exporting `config`, under `edgecape_tpu_torch/configs/`) and
dotted-path overrides from the command line. Counterpart of
edgecape_tpu/config.py, field for field.

The rest of the port reads a configuration by attribute, so any object
with these fields works: the dataclasses below, the JAX package's own, or
a `types.SimpleNamespace`. `replace` and `asdict` take all three;
`stage2_config` / `stage3_config` spell the curriculum stages.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


@dataclass
class ModelConfig:
    # backbone
    backbone: str = "dinov2_vits14"
    backbone_dim: int = 384
    image_size: int = 224
    patch_size: int = 14
    # head / transformer
    d_model: int = 256
    nhead: int = 8
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    dim_feedforward: int = 384
    dropout: float = 0.1
    similarity_proj_dim: int = 256
    dynamic_proj_dim: int = 128
    num_feats: int = 128          # sine pos-enc feats (2*num_feats = d_model)
    max_kpt: int = 100
    heatmap_size: int = 64
    # skeleton predictor
    skeleton_num_layers: int = 3
    use_zero_conv: bool = True
    adj_normalization: bool = True
    # curriculum knobs
    learn_skeleton: bool = False
    masked_supervision: bool = False
    masking_ratio: float = 0.5
    attn_bias: bool = False
    # numerically inert on its own (it records which attention layout a
    # reference checkpoint used); the hop-bias MLP and the biased logits
    # follow attn_bias alone
    use_bias_attn_module: bool = False
    max_hops: int = 4
    model_freeze: Optional[str] = None  # None | 'skeleton' | 'prediction'
    # losses
    with_heatmap_loss: bool = False
    heatmap_loss_weight: float = 2.0
    skeleton_loss_weight: float = 1.0
    # numerics
    compute_dtype: str = "float32"  # 'bfloat16' for the fast path
    # The hand-written kernels in the backbone and the head. None = on for
    # a CUDA device, off on the CPU (the estimator and the trainer resolve
    # it from their device); an explicit False is the strict-parity mode
    # (plain PyTorch, no bf16 casts inside the ops).
    use_flash: Optional[bool] = None
    # 'bfloat16' runs the cached-eval query phase (encoder + decoder) in
    # bf16; the support phase and the uncached paths remain fp32
    head_dtype: str = "float32"
    # run the frozen backbone through the bf16 fused blocks inside the
    # train step (CUDA only); False = the plain trunk at compute_dtype
    train_backbone_fast: bool = True


@dataclass
class DataConfig:
    ann_file: str = ""
    img_prefix: str = ""
    num_shots: int = 1
    num_queries: int = 15
    num_episodes: int = 200
    image_size: int = 224
    heatmap_size: int = 64
    max_kpt: int = 100
    sigma: float = 1.0
    use_udp: bool = False
    # MSRA unbiased (Dark-pose style) target encoding: continuous
    # sub-pixel gaussian center, no window truncation (reference
    # top_down_transform.py:140-163; off in all shipped configs)
    unbiased_encoding: bool = False
    # train-time augmentation (reference TopDownGetRandomScaleRotation)
    rot_factor: float = 15.0
    scale_factor: float = 0.15
    rot_prob: float = 0.6
    pck_threshold_list: Sequence[float] = (0.05, 0.10, 0.15, 0.20, 0.25)
    valid_class_ids: Optional[Sequence[int]] = None
    # pin specific query image file_names for qualitative runs (the
    # reference's CustomTestPoseDataset behavior)
    pin_query_images: Optional[Sequence[str]] = None
    synthetic: bool = False          # use the synthetic MP-100 stand-in
    synthetic_num_classes: int = 10
    synthetic_images_per_class: int = 30
    # dataset composition (the reference code's build_dataset):
    # additional annotation files concatenated for joint training, and
    # whole-dataset repetition per epoch
    extra_ann_files: Optional[Sequence[str]] = None
    repeat_times: int = 1


@dataclass
class TrainConfig:
    total_epochs: int = 100
    lr: float = 1e-5
    warmup_iters: int = 1000
    warmup_ratio: float = 0.001
    lr_step: Sequence[int] = (160, 180)
    lr_gamma: float = 0.1
    batch_size: int = 16           # GLOBAL batch, sharded over the
                                   # mesh (reference used 16/GPU)
    eval_interval: int = 25
    ckpt_interval: int = 20
    log_interval: int = 50
    seed: int = 1
    grad_clip: Optional[float] = None
    num_workers: int = 8
    # TensorBoard scalar curves (reference TensorboardLoggerHook,
    # configs/train/1shot_split1.py:27-32); events go to work_dir/tf_logs
    tensorboard: bool = True


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train_data: DataConfig = field(default_factory=DataConfig)
    val_data: DataConfig = field(default_factory=DataConfig)
    test_data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    work_dir: str = "work_dirs/exp"
    load_from: Optional[str] = None
    resume_from: Optional[str] = None

    # ------------------------------------------------------------------ io
    @staticmethod
    def from_file(path: str) -> "Config":
        spec = importlib.util.spec_from_file_location("exp_config", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg = getattr(mod, "config")
        if not isinstance(cfg, Config):
            raise TypeError(f"{path} must define `config: Config`")
        return cfg

    def override(self, options: Sequence[str]) -> "Config":
        """Apply 'a.b.c=value' dotted overrides (values parsed as JSON,
        falling back to string), the --cfg-options of the CLIs."""
        cfg = self
        for opt in options or []:
            key, _, raw = opt.partition("=")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            cfg = _replace_path(cfg, key.split("."), value)
        return cfg

    def dump(self, path: str) -> None:
        dump(self, path)


def _declared_type(obj: Any, name: str) -> str:
    """The field's DECLARED annotation string ('' if unknown). The runtime
    value can be None (use_flash's tri-state default), which an isinstance
    check on the current value cannot see — overriding
    `model.use_flash=False` on a config that leaves it None must still be
    validated, or the string 'False' would later resolve truthy."""
    for f in dataclasses.fields(obj):
        if f.name == name:
            return str(f.type)
    return ""


def _coerce(obj: Any, field: str, value: Any) -> Any:
    """Validate an override value against the declared field type so a typo
    like use_udp=notabool errors instead of silently storing a truthy
    string in a bool field."""
    current = getattr(obj, field)
    decl = _declared_type(obj, field)
    if decl in ("bool", "Optional[bool]", "typing.Optional[bool]"):
        optional = "Optional" in decl
        if isinstance(value, bool) or (value is None and optional):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "false"):
                return low == "true"
            if low in ("none", "null") and optional:
                return None
        raise ValueError(f"config field {field!r} is a bool; got {value!r} "
                         "(use true/false)")
    if isinstance(current, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise ValueError(f"config field {field!r} is a bool; got {value!r} "
                         "(use true/false)")
    if isinstance(current, int) and not isinstance(current, bool) \
            and isinstance(value, str):
        raise ValueError(f"config field {field!r} is an int; got {value!r}")
    if isinstance(current, float):
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        raise ValueError(f"config field {field!r} is a float; got {value!r}")
    return value


def _replace_path(obj: Any, parts: list[str], value: Any) -> Any:
    if len(parts) == 1:
        if not hasattr(obj, parts[0]):
            raise KeyError(f"unknown config field {parts[0]!r} on "
                           f"{type(obj).__name__}")
        return dataclasses.replace(obj, **{parts[0]: _coerce(obj, parts[0],
                                                             value)})
    child = getattr(obj, parts[0])
    return dataclasses.replace(
        obj, **{parts[0]: _replace_path(child, parts[1:], value)})


def replace(obj, **changes):
    """A copy of `obj` with the given fields changed."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **changes)
    out = copy.copy(obj)
    for k, v in changes.items():
        if not hasattr(out, k):
            raise KeyError(f"unknown config field {k!r}")
        setattr(out, k, v)
    return out


def asdict(obj):
    """Nested plain dicts of a configuration object."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    if hasattr(obj, "__dict__"):
        return {k: asdict(v) for k, v in vars(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [asdict(v) for v in obj]
    return obj


def dump(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(asdict(cfg), f, indent=2, default=str)


def stage2_config(cfg, masking_ratio: float = 0.5,
                  skeleton_loss_weight: float = 1.0):
    """Curriculum stage 2: learned edge weights and masked-keypoint
    supervision."""
    model = replace(cfg.model, learn_skeleton=True, masked_supervision=True,
                    masking_ratio=masking_ratio,
                    skeleton_loss_weight=skeleton_loss_weight)
    return replace(cfg, model=model)


def stage3_config(cfg):
    """Curriculum stage 3: stage 2 plus the structural attention bias,
    with the skeleton branch frozen."""
    model = replace(stage2_config(cfg).model, use_bias_attn_module=True,
                    attn_bias=True, max_hops=4, model_freeze="skeleton")
    return replace(cfg, model=model)
