"""Dataset composition: Repeat and Concat wrappers; counterpart of
edgecape_tpu/data/compose.py.

ConcatDataset joins per-annotation-file datasets, RepeatDataset repeats a
dataset N times per epoch (shortens inter-epoch bookkeeping for small
datasets). Plain wrappers satisfying the Prefetcher / Trainer interface
(len, collate, collate_native, resample_episodes, attribute passthrough).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class RepeatDataset:
    """len(dataset) * times virtual epochs (reference RepeatDataset)."""

    def __init__(self, dataset, times: int):
        assert times >= 1
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def _fold(self, indices):
        n = len(self.dataset)
        return [int(i) % n for i in indices]

    def collate(self, indices, **kw):
        return self.dataset.collate(self._fold(indices), **kw)

    def collate_native(self, indices, **kw):
        return self.dataset.collate_native(self._fold(indices), **kw)

    def resample_episodes(self):
        self.dataset.resample_episodes()

    def __getattr__(self, name):
        return getattr(self.dataset, name)


class ConcatDataset:
    """Episode-level concatenation of datasets with identical collate
    shapes (same image_size/heatmap_size/max_kpt), e.g. several MP-100
    annotation files trained jointly (reference ConcatDataset)."""

    def __init__(self, datasets: Sequence):
        assert datasets
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def _locate(self, idx: int):
        di = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return di, int(idx - self.offsets[di])

    def _collate_via(self, method, indices, **kw):
        # group by child dataset, collate each group once, then restore
        # the caller's batch order
        located = [self._locate(int(i)) for i in indices]
        by_child: dict = {}
        for pos, (di, li) in enumerate(located):
            by_child.setdefault(di, []).append((pos, li))
        parts = {}
        for di, items in by_child.items():
            sub_kw = dict(kw)
            if isinstance(kw.get("rng"), (list, tuple)):
                # per-sample rng plans follow their samples to the child
                sub_kw["rng"] = [kw["rng"][pos] for pos, _ in items]
            batch = getattr(self.datasets[di], method)(
                [li for _, li in items], **sub_kw)
            parts[di] = (batch, [pos for pos, _ in items])
        first = next(iter(parts.values()))[0]
        out = {}
        for field in type(first).__dataclass_fields__:
            if field == "meta":
                continue
            buf = None
            for batch, positions in parts.values():
                arr = getattr(batch, field)
                if buf is None:
                    buf = np.empty((len(indices),) + arr.shape[1:],
                                   arr.dtype)
                buf[positions] = arr
            out[field] = buf
        meta = {}
        for key in first.meta:
            vals = [None] * len(indices)
            for batch, positions in parts.values():
                for j, pos in enumerate(positions):
                    vals[pos] = batch.meta[key][j]
            if isinstance(first.meta[key], np.ndarray):
                meta[key] = np.asarray(vals)
            else:
                meta[key] = vals
        out["meta"] = meta
        return type(first)(**out)

    def collate(self, indices, **kw):
        return self._collate_via("collate", indices, **kw)

    def collate_native(self, indices, **kw):
        return self._collate_via("collate_native", indices, **kw)

    def resample_episodes(self):
        for d in self.datasets:
            d.resample_episodes()

    # dataset-identity members that only make sense on a single child:
    # silently delegating them to datasets[0] while len() reports the
    # concatenated total would mispair eval records with ground truth
    _IDENTITY_ATTRS = frozenset({
        "db", "paired_samples", "support_groups", "collate_group",
        "batches", "name2id", "img_prefix"})

    def __getattr__(self, name):
        if name in ConcatDataset._IDENTITY_ATTRS:
            raise AttributeError(
                f"ConcatDataset does not expose {name!r}: it is a "
                "train-composition wrapper; evaluate each child dataset "
                "separately")
        return getattr(self.datasets[0], name)


def build_train_dataset(cfg):
    """DataConfig -> dataset, honoring `extra_ann_files` (ConcatDataset)
    and `repeat_times` (RepeatDataset)."""
    from ..config import replace
    from .mp100 import MP100Dataset

    ds = MP100Dataset(cfg, mode="train")
    extra = getattr(cfg, "extra_ann_files", None) or []
    if extra:
        others = [MP100Dataset(replace(cfg, ann_file=a, extra_ann_files=None),
                               mode="train")
                  for a in extra]
        ds = ConcatDataset([ds] + others)
    times = getattr(cfg, "repeat_times", 1) or 1
    if times > 1:
        ds = RepeatDataset(ds, times)
    return ds
