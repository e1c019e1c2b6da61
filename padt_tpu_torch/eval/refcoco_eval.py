"""RefCOCO/+/g REC + RES scorers; the port's copy of
`padt_tpu/eval/refcoco_eval.py`, with OpenCV's uint8 resize of a predicted
mask done by `utils.resize.resize_linear_u8` (bit-equal, no cv2).

Rebuilds `eval/evaluation_scripts/eval_refcoco.py:44-134`:
  - REC: AP@IoU>=0.5 over boxes, grouped by `imageid_label`, taking the
    max-IoU prediction per group (`eval_refcoco.py:110-119`),
  - RES: cumulative mask IoU (cIoU = total intersection / total union) over the
    same grouping, using each group's best-box prediction's mask
    (`eval_refcoco.py:100-109,121-134`).

Predictions/GT use the harness JSONL schema (same as the reference
`utils.py:249-266` so either scorer can consume either side's files).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..utils.resize import resize_linear_u8
from . import rle as rle_codec


def _xywh_iou(a: Sequence[float], b: Sequence[float]) -> float:
    ax1, ay1, ax2, ay2 = a[0], a[1], a[0] + a[2], a[1] + a[3]
    bx1, by1, bx2, by2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
    ix = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    iy = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = ix * iy
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def score_refcoco(
    gt_items: List[Dict],  # {image_id, label, bbox [x,y,w,h] px, (rle)}
    pred_items: List[Dict],  # harness rows: {image_id, category, bbox, score, (mask)}
) -> Dict[str, float]:
    """Returns {'ap50': REC accuracy, 'ciou': RES cumulative IoU,
    'mask_ap50': RES AP@0.5 over masks}."""
    preds = defaultdict(list)
    for p in pred_items:
        preds[(p["image_id"], str(p.get("category", "")).strip().lower())].append(p)

    hits = 0
    total = 0
    inter_sum = 0.0
    union_sum = 0.0
    mask_hits = 0
    mask_total = 0
    for gt in gt_items:
        key = (gt["image_id"], str(gt["label"]).strip().lower())
        total += 1
        cand = preds.get(key, [])
        best_iou = 0.0
        best = None
        for p in cand:
            iou = _xywh_iou(p["bbox"], gt["bbox"])
            if iou >= best_iou:
                best_iou = iou
                best = p
        if best_iou >= 0.5:
            hits += 1
        if "rle" in gt and gt["rle"]:
            mask_total += 1
            gm = rle_codec.decode(gt["rle"]).astype(bool)
            if best is not None and best.get("mask"):
                pm = rle_codec.decode(best["mask"]).astype(bool)
                if pm.shape != gm.shape:
                    pm = resize_linear_u8(pm.astype(np.uint8), (gm.shape[1], gm.shape[0])) > 0
                inter = float(np.logical_and(pm, gm).sum())
                union = float(np.logical_or(pm, gm).sum())
                miou = inter / union if union > 0 else 0.0
            else:
                inter, union = 0.0, float(gm.sum())
                miou = 0.0
            inter_sum += inter
            union_sum += union
            if miou >= 0.5:
                mask_hits += 1

    return {
        "ap50": hits / total if total else 0.0,
        "ciou": inter_sum / union_sum if union_sum > 0 else 0.0,
        "mask_ap50": mask_hits / mask_total if mask_total else 0.0,
        "num_gt": total,
    }
