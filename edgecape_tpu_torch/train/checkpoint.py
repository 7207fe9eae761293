"""Checkpoint save / load / resume; counterpart of
edgecape_tpu/train/checkpoint.py.

A checkpoint is one `torch.save` file named like the JAX package's
checkpoint directories (`epoch_N`, `best_PCK_epoch_N`), holding the
head's state dict, the optimizer's state dict, the step, the epoch and
the best PCK so far, with a `<name>.meta.json` sidecar beside it and a
`latest.json` pointer in the work directory.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch


def save_checkpoint(path: str, tree: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def write_latest(work_dir: str, name: str) -> None:
    with open(os.path.join(work_dir, "latest.json"), "w") as f:
        json.dump({"latest": name}, f)


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """work_dir/latest.json -> checkpoint path (auto-resume)."""
    p = os.path.join(work_dir, "latest.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = json.load(f)["latest"]
    path = os.path.join(work_dir, name)
    return path if os.path.exists(path) else None


def best_checkpoint(work_dir: str) -> Optional[str]:
    """The best_* checkpoint of the highest epoch (sorted by the number,
    not as text), else the latest one."""
    def epoch_of(name: str) -> int:
        m = re.search(r"(\d+)$", name)
        return int(m.group(1)) if m else -1

    if os.path.isdir(work_dir):
        names = [n for n in os.listdir(work_dir)
                 if n.startswith("best_") and not n.endswith(".json")]
        if names:
            names.sort(key=epoch_of)
            return os.path.join(work_dir, names[-1])
    return latest_checkpoint(work_dir)


def merge_params(template: dict, loaded: dict) -> dict:
    """Non-strict warm start over state dicts: entries of `template`
    whose name exists in `loaded` with the same shape take the loaded
    value, the rest keep their fresh initialisation (new modules appear
    at curriculum stages 2 and 3)."""
    out = {}
    for name, value in template.items():
        other = loaded.get(name)
        if other is not None and tuple(other.shape) == tuple(value.shape):
            out[name] = other.to(value.dtype)
        else:
            out[name] = value
    return out
