"""Minimal pure-Python COCO-json index.

Replaces the reference's xtcocotools.coco.COCO dependency (a Cython COCO API
used only for annotation indexing at transformer_dataset.py:35): MP-100
jsons are small and need no mask ops, so a dict-based index is all that's
required. Iteration orders match the COCO API (file order for categories
and images, getAnnIds per image in file order) so episode sampling is
bit-compatible.
"""

from __future__ import annotations

import json
from collections import defaultdict


class CocoIndex:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {img["id"]: img for img in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.anns = {a["id"]: a for a in d.get("annotations", [])}
        self._img_to_anns = defaultdict(list)
        for a in d.get("annotations", []):
            self._img_to_anns[a["image_id"]].append(a)

    def get_img_ids(self):
        return list(self.imgs.keys())

    def get_cat_ids(self):
        return list(self.cats.keys())

    def load_img(self, img_id):
        return self.imgs[img_id]

    def img_anns(self, img_id, *, iscrowd: bool = False):
        anns = self._img_to_anns.get(img_id, [])
        if iscrowd is None:
            return anns
        return [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]
