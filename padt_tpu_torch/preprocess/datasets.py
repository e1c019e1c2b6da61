"""Offline dataset preprocessing: COCO / RefCOCO / RIC -> training JSONL;
the port's copy of `padt_tpu/preprocess/datasets.py`, with OpenCV's uint8
resize in `patch_occupancy` done by `utils.resize.resize_linear_u8`
(bit-equal, no cv2).

Rebuilds `src/preprocess/{process_coco,process_refcoco,process_ric}.py` with
recipe parity (patch ids feed VRT supervision, so rounding must match):
  - resolution filter: skip images with max side > 1288 (process_coco.py:42-44),
  - patch occupancy: resize (mask*255) to round(side/28)*28, average over each
    28x28 cell, threshold 255/28 — `>=` for COCO/RIC, `>` for RefCOCO
    (process_coco.py:74-78, process_refcoco.py:75-76),
  - normalized xyxy bboxes, RLE segmentation, `<|Obj_k|>` answer templates,
  - COCO OVD: per-category caps, train-time random category drops, the
    There is/are template grammar (process_coco.py:135-164),
  - RefCOCO: one sample per sentence (process_refcoco.py:83-112),
  - RIC: the four `<box_id: N/>` caption repair passes (process_ric.py:37-66).

Uses our own COCO index + RLE codec (pycocotools absent here).
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..eval import rle as rle_codec
from ..utils.resize import resize_linear_u8


class CocoIndex:
    """Minimal COCO annotation index (pycocotools.coco.COCO subset)."""

    def __init__(self, json_path: str):
        with open(json_path) as f:
            data = json.load(f)
        self.imgs = {im["id"]: im for im in data["images"]}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[Dict]] = defaultdict(list)
        self.anns = {}
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann

    def ann_to_mask(self, ann: Dict) -> np.ndarray:
        im = self.imgs[ann["image_id"]]
        return rle_codec.ann_to_mask(ann, im["height"], im["width"])


def patch_occupancy(mask: np.ndarray, inclusive: bool = True) -> Optional[np.ndarray]:
    """Binary mask -> flat indices of occupied 28px grid cells (raster order).
    Returns None when no cell passes the threshold (sample skipped)."""
    ori_h, ori_w = mask.shape[:2]
    rh, rw = int(round(ori_h / 28) * 28), int(round(ori_w / 28) * 28)
    resized = resize_linear_u8(mask.astype(np.uint8) * 255, (rw, rh))
    cells = resized.reshape(rh // 28, 28, rw // 28, 28).transpose(0, 2, 1, 3).mean(axis=(-1, -2))
    pm = cells >= 255 / 28 if inclusive else cells > 255 / 28
    if pm.sum() < 1:
        return None
    return np.where(pm.reshape(-1))[0]


def _norm_xyxy(bbox_xywh, ori_w, ori_h):
    x, y, w, h = bbox_xywh
    return [x / ori_w, y / ori_h, (x + w) / ori_w, (y + h) / ori_h]


def _object_entry(ann: Dict, coco: CocoIndex, label: str = "", inclusive: bool = True) -> Optional[Dict]:
    im = coco.imgs[ann["image_id"]]
    ori_h, ori_w = im["height"], im["width"]
    if "segmentation" in ann and ann["segmentation"]:
        mask = coco.ann_to_mask(ann)
        patches = patch_occupancy(mask, inclusive)
        if patches is None:
            return None
        save_rle = rle_codec.encode(mask.astype(np.uint8))
        entry = {"rle": {"size": save_rle["size"], "counts": save_rle["counts"]}}
    else:
        mask = np.zeros((ori_h, ori_w), np.uint8)
        x, y, w, h = ann["bbox"]
        mask[round(y): round(y + h), round(x): round(x + w)] = 1
        patches = patch_occupancy(mask, inclusive)
        if patches is None:
            return None
        entry = {}
    entry.update(
        patches=patches.tolist(),
        bbox=_norm_xyxy(ann["bbox"], ori_w, ori_h),
        iscrowd=ann.get("iscrowd", 0),
        area=ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
        label=label,
    )
    return entry


def process_coco(
    input_json: str,
    output_jsonl: str,
    max_bboxes_per_class_per_image: int = 50,
    is_train: bool = False,
    drop_rate: float = 0.5,
    max_class_in_prompt: int = 100,
    seed: Optional[int] = None,
) -> Dict[str, int]:
    """COCO instances -> OVD JSONL (process_coco.py semantics)."""
    rng = np.random.RandomState(seed)
    coco = CocoIndex(input_json)
    os.makedirs(os.path.dirname(os.path.abspath(output_jsonl)), exist_ok=True)
    stats = {"skipped_small_mask": 0, "total_objects": 0, "skip_resolution": 0, "images": 0}
    category_index = np.array(sorted(coco.cats))

    with open(output_jsonl, "w") as out:
        for img_id in sorted(coco.imgs):
            im = coco.imgs[img_id]
            if max(im["height"], im["width"]) > 1288:
                stats["skip_resolution"] += 1
                continue
            anns = coco.img_to_anns.get(img_id, [])
            counts = defaultdict(int)
            for ann in anns:
                counts[ann["category_id"]] += 1

            remove = set()
            if is_train:
                rng.shuffle(category_index)
                remove.update(category_index[max_class_in_prompt:].tolist())
                if rng.rand() < drop_rate:
                    remove.update(
                        category_index[: int(drop_rate * min(len(category_index), max_class_in_prompt))].tolist()
                    )
            cat_order = {c: i for i, c in enumerate(category_index)}

            answer_list = []
            for cat_id, cnt in sorted(counts.items(), key=lambda kv: cat_order[kv[0]]):
                remove.discard(cat_id)
                if cnt > max_bboxes_per_class_per_image:
                    remove.add(cat_id)
                    continue
                objs = []
                for ann in anns:
                    if ann["category_id"] != cat_id:
                        continue
                    e = _object_entry(ann, coco, label=coco.cats[cat_id]["name"], inclusive=True)
                    if e is None:
                        stats["skipped_small_mask"] += 1
                        continue
                    objs.append(e)
                    stats["total_objects"] += 1
                if objs:
                    answer_list.append({"label": coco.cats[cat_id]["name"], "objects": objs})

            # answer template grammar (process_coco.py:135-164)
            per_cat = [len(a["objects"]) for a in answer_list]
            if not per_cat:
                template = "No objects from the list are present in the image"
            elif len(per_cat) == 1:
                template = "There is " if sum(per_cat) == 1 else "There are "
            else:
                template = "In this image, there are "
            objects = []
            for ci, cat in enumerate(answer_list):
                template += f'{len(cat["objects"])} "{cat["label"]}" ('
                for oi, obj in enumerate(cat["objects"]):
                    template += f"<|Obj_{len(objects)}|>"
                    objects.append(obj)
                    template += ", " if oi < len(cat["objects"]) - 1 else ")"
                if ci < len(answer_list) - 1:
                    template += ", "
            template += " in this image." if len(per_cat) == 1 else "."

            target = sorted(set(coco.cats) - remove, key=lambda c: cat_order[c])
            names = [coco.cats[c]["name"] for c in target]
            row = {
                "id": img_id,
                "image": im["file_name"],
                "conversations": [
                    {
                        "from": "human",
                        "value": "Please carefully check the image and detect the following objects: "
                        + json.dumps(names)
                        + ".",
                    }
                ],
                "answer_template": template,
                "objects": objects,
                "task": "ovd",
            }
            out.write(json.dumps(row) + "\n")
            stats["images"] += 1
    return stats


def process_refcoco_items(
    items: Sequence[Dict],
    output_jsonl: str,
) -> Dict[str, int]:
    """Generic referring-expression rows -> REC/RES JSONL.

    Each item: {id, image (file name), height, width, sentences: [str],
    bbox [x,y,w,h px], segmentation (COCO poly/RLE), iscrowd, area}.
    (The REFER pickle loader in preprocess/refer_api.py produces these.)"""
    stats = {"skipped_small_mask": 0, "rows": 0}
    with open(output_jsonl, "w") as out:
        for it in items:
            h, w = it["height"], it["width"]
            seg = it["segmentation"]
            if isinstance(seg, list) and seg and isinstance(seg[0], list):
                m = rle_codec.poly_to_mask(seg, h, w)
            elif isinstance(seg, dict):
                m = rle_codec.decode(seg)
            else:
                m = np.asarray(seg, np.uint8)
            m = (m >= 1).astype(np.uint8)
            patches = patch_occupancy(m, inclusive=False)  # strict > (process_refcoco.py:76)
            if patches is None:
                stats["skipped_small_mask"] += 1
                continue
            save_rle = rle_codec.encode(m)
            bx, by, bw, bh = it["bbox"]
            for sent in it["sentences"]:
                row = {
                    "id": it["id"],
                    "image": it["image"],
                    "conversations": [
                        {
                            "from": "human",
                            "value": 'Please carefully check the image and detect the object this sentence describes: "'
                            + sent
                            + '".',
                        }
                    ],
                    "task": "refering",
                    "answer_template": f'The "{sent}" refers to <|Obj_0|> in this image.',
                    "objects": [
                        {
                            "patches": patches.tolist(),
                            "bbox": [bx / w, by / h, (bx + bw) / w, (by + bh) / h],
                            "iscrowd": it.get("iscrowd", 0),
                            "area": it.get("area", bw * bh),
                            "rle": {"size": save_rle["size"], "counts": save_rle["counts"]},
                            "label": sent,
                        }
                    ],
                }
                out.write(json.dumps(row) + "\n")
                stats["rows"] += 1
    return stats


# --- RIC caption repair (process_ric.py:37-66) ---

_RIC_P1 = re.compile(r"(\(\d+(,\s*\d+)*\))")
_RIC_P2 = re.compile(r"(<box_id:\s*[^>\d]+(\d+)/?>)")
_RIC_P3 = re.compile(r"(<box_id:\s*[^>\d]*\d+/?(,\s*\d+/?)+>)")
_RIC_P4 = re.compile(r"(<box_id:\s*[^>\d]*(\d+)/(?!>))")
_RIC_TAG = re.compile(r"(<box_id:\s*(\d+)/?>)")
_RIC_SPLIT = re.compile(r"<box_id:\s*\d+/?>")


def repair_ric_caption(caption: str, valid_ann_ids: Sequence[int]) -> str:
    valid = set(int(a) for a in valid_ann_ids)
    for m in _RIC_P1.findall(caption):
        s = m[0]
        rep = s
        for idx in re.findall(r"(\d+)", s):
            if int(idx) in valid:
                rep = rep.replace(idx, f"<box_id: {idx}/>")
        caption = caption.replace(s, rep)
    for m in _RIC_P2.findall(caption):
        caption = caption.replace(m[0], f"<box_id: {m[1]}/>")
    for m in _RIC_P3.findall(caption):
        idxs = re.findall(r"(\d+)", m[0])
        caption = caption.replace(m[0], ", ".join(f"<box_id: {i}/>" for i in idxs))
    for m in _RIC_P4.findall(caption):
        caption = caption.replace(m[0], f"<box_id: {m[1]}/>")
    return caption


def process_ric(input_json: str, output_jsonl: str) -> Dict[str, int]:
    """Captions with `<box_id: N/>` tags -> RIC JSONL (process_ric.py)."""
    coco = CocoIndex(input_json)
    stats = {"skipped_small_mask": 0, "rows": 0, "bad_captions": 0}
    with open(output_jsonl, "w") as out:
        for img_id in sorted(coco.imgs):
            im = coco.imgs[img_id]
            ann_ids = [a["id"] for a in coco.img_to_anns.get(img_id, [])]
            for caption in im.get("captions", []):
                if not caption or (caption[-1] != "." and caption[-1] != '"'):
                    stats["bad_captions"] += 1
                    continue
                caption = repair_ric_caption(caption, ann_ids)
                tags = _RIC_TAG.findall(caption)
                ids = [int(t[1]) for t in tags]
                parts = _RIC_SPLIT.split(caption)
                new_caption = parts[0]
                objects = []
                for ann_id, part in zip(ids, parts[1:]):
                    ann = coco.anns.get(ann_id)
                    entry = None
                    if ann is not None and ann["image_id"] == img_id:
                        entry = _object_entry(ann, coco, label="", inclusive=True)
                    if entry is None:
                        stats["skipped_small_mask"] += 1
                        # drop this box from the caption (process_ric.py:92-99)
                        if new_caption[-2:] == ", ":
                            new_caption = new_caption[:-2] + part
                        elif new_caption and new_caption[-1] == "(":
                            if part and part[0] == ")":
                                new_caption = new_caption[:-2] + part[1:]
                            else:
                                new_caption += part[2:]
                        continue
                    new_caption += f"<|Obj_{len(objects)}|>" + part
                    objects.append(entry)
                if not objects:
                    continue
                row = {
                    "id": img_id,
                    "image": im["file_name"],
                    "conversations": [{"from": "human", "value": "Please describe this image."}],
                    "task": "ric",
                    "answer_template": new_caption,
                    "objects": objects,
                }
                out.write(json.dumps(row) + "\n")
                stats["rows"] += 1
    return stats
