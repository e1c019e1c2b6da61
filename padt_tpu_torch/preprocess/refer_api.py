"""Referring-expressions dataset loader (RefCOCO/+/g); the port's copy of
`padt_tpu/preprocess/refer_api.py`.

Compact rebuild of the vendored UNC REFER API (reference
`src/preprocess/refer.py:1-390`): loads `refs(<splitBy>).p` (pickle) +
`instances.json`, indexes refs/anns/images, and yields the rows
`process_refcoco_items` consumes."""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterator, List, Optional

from .datasets import CocoIndex


class ReferDataset:
    def __init__(self, data_root: str, dataset: str = "refcoco", split_by: Optional[str] = None):
        if split_by is None:
            split_by = "umd" if dataset == "refcocog" else "unc"
        base = os.path.join(data_root, dataset)
        with open(os.path.join(base, f"refs({split_by}).p"), "rb") as f:
            self.refs: List[Dict] = pickle.load(f)
        self.coco = CocoIndex(os.path.join(base, "instances.json"))

    def iter_items(self, split: str = "train") -> Iterator[Dict]:
        """Yields rows for `process_refcoco_items`: one per ref (all sentences)."""
        for ref in self.refs:
            if ref.get("split") != split:
                continue
            ann = self.coco.anns.get(ref["ann_id"])
            if ann is None:
                continue
            im = self.coco.imgs[ref["image_id"]]
            yield {
                "id": ref["image_id"],
                "image": im["file_name"],
                "height": im["height"],
                "width": im["width"],
                "sentences": [s["sent"] for s in ref["sentences"]],
                "bbox": ann["bbox"],
                "segmentation": ann.get("segmentation"),
                "iscrowd": ann.get("iscrowd", 0),
                "area": ann.get("area"),
            }


def process_refcoco(
    data_root: str, dataset: str, split: str, output_jsonl: str, split_by: Optional[str] = None
):
    from .datasets import process_refcoco_items

    ds = ReferDataset(data_root, dataset, split_by)
    return process_refcoco_items(list(ds.iter_items(split)), output_jsonl)
