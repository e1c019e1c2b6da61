"""COCO-style mAP evaluator (bbox + segm); the port's copy of
`padt_tpu/eval/coco_map.py`, unchanged but for this line.

Replaces pycocotools' COCOeval for the OVD oracle (reference
`eval/evaluation_scripts/eval_coco.py:78-93` computes COCOeval bbox mAP and
reports stats[0]). Implements the standard protocol: greedy per-image matching
sorted by score, 10 IoU thresholds .50:.95, 101-point interpolated precision,
area ranges (all/small/medium/large), maxDets (1/10/100), crowd handling.

Boxes are (x, y, w, h) pixels. Masks are RLE dicts (eval/rle.py).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import rle as rle_codec

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def box_iou_xywh(d: np.ndarray, g: np.ndarray, iscrowd: Sequence[bool]) -> np.ndarray:
    """(D,4) x (G,4) -> (D,G) IoU; crowd GTs use intersection/det-area."""
    if d.size == 0 or g.size == 0:
        return np.zeros((d.shape[0], g.shape[0]))
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    ix = np.clip(np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None]), 0, None)
    iy = np.clip(np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = ix * iy
    da = (d[:, 2] * d[:, 3])[:, None]
    ga = (g[:, 2] * g[:, 3])[None]
    crowd = np.asarray(iscrowd, bool)[None].repeat(d.shape[0], 0)
    union = np.where(crowd, da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mask_iou_rle(dts: List[Dict], gts: List[Dict], iscrowd: Sequence[bool]) -> np.ndarray:
    out = np.zeros((len(dts), len(gts)))
    for i, dr in enumerate(dts):
        for j, gr in enumerate(gts):
            # native decode-free run-walk when available (eval/rle.py)
            out[i, j] = rle_codec.mask_iou(dr, gr, iscrowd=bool(iscrowd[j]))
    return out


@dataclass
class _ImgCatEval:
    dt_scores: np.ndarray  # (D,)
    dt_matches: np.ndarray  # (T, D) matched gt flag (0/1) per IoU thr
    dt_ignore: np.ndarray  # (T, D)
    num_gt: int  # non-ignored GTs


def _dt_area(d: Dict, iou_type: str) -> float:
    """Detection area per pycocotools loadRes: bbox results use w*h, segm
    results use the MASK area (falling back to bbox area would misplace
    ring/sparse masks across area ranges)."""
    if "area" in d:
        return d["area"]
    if iou_type == "segm" and "segmentation" in d:
        return float(rle_codec.area(d["segmentation"]))
    return d["bbox"][2] * d["bbox"][3]


def _evaluate_img(
    dts: List[Dict], gts: List[Dict], ious: np.ndarray, area_rng: Tuple[float, float], max_det: int,
    iou_type: str = "bbox",
) -> Optional[_ImgCatEval]:
    if not dts and not gts:
        return None
    gt_ignore = np.array(
        [g.get("iscrowd", 0) == 1 or not (area_rng[0] <= g["area"] <= area_rng[1]) for g in gts],
        bool,
    ) if gts else np.zeros((0,), bool)
    # sort gts: non-ignored first (pycocotools order)
    gt_order = np.argsort(gt_ignore, kind="stable")
    gts_sorted = [gts[i] for i in gt_order]
    gt_ignore = gt_ignore[gt_order]

    scores = np.array([d["score"] for d in dts]) if dts else np.zeros((0,))
    dt_order = np.argsort(-scores, kind="stable")[:max_det]
    dts_sorted = [dts[i] for i in dt_order]
    scores = scores[dt_order]
    iou = ious[dt_order][:, gt_order] if ious.size else np.zeros((len(dts_sorted), len(gts_sorted)))

    t_n = len(IOU_THRS)
    d_n = len(dts_sorted)
    g_n = len(gts_sorted)
    dtm = np.zeros((t_n, d_n))
    gtm = np.zeros((t_n, g_n))
    dt_ig = np.zeros((t_n, d_n), bool)
    for ti, thr in enumerate(IOU_THRS):
        for di in range(d_n):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(g_n):
                if gtm[ti, gi] > 0 and not gts_sorted[gi].get("iscrowd", 0):
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break  # can't improve past non-ignored match into ignored region
                if iou[di, gi] < best:
                    continue
                best = iou[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[ti, di] = gt_ignore[m]
            dtm[ti, di] = 1
            gtm[ti, m] = 1
    # detections outside the area range that matched nothing are ignored
    d_areas = np.array(
        [_dt_area(d, iou_type) for d in dts_sorted]
    ) if dts_sorted else np.zeros((0,))
    out_of_rng = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
    dt_ig = dt_ig | (out_of_rng[None] & (dtm == 0))
    return _ImgCatEval(
        dt_scores=scores,
        dt_matches=dtm,
        dt_ignore=dt_ig,
        num_gt=int((~gt_ignore).sum()),
    )


class COCOEvaluator:
    """evaluate(gt_anns, dt_anns, iou_type) -> 12 COCO stats.

    gt anns: {image_id, category_id, bbox [x,y,w,h], area, iscrowd, (segmentation)}
    dt anns: {image_id, category_id, bbox, score, (segmentation)}
    """

    def __init__(self, iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type

    def evaluate(self, gts: List[Dict], dts: List[Dict]) -> Dict[str, float]:
        by_key_gt = defaultdict(list)
        by_key_dt = defaultdict(list)
        cats = set()
        imgs = set()
        for g in gts:
            by_key_gt[(g["image_id"], g["category_id"])].append(g)
            cats.add(g["category_id"])
            imgs.add(g["image_id"])
        for d in dts:
            by_key_dt[(d["image_id"], d["category_id"])].append(d)
            cats.add(d["category_id"])
            imgs.add(d["image_id"])
        cats = sorted(cats)
        imgs = sorted(imgs)

        # IoUs once per (img, cat) at maxDet=100
        iou_cache: Dict[Tuple, np.ndarray] = {}
        for key in set(list(by_key_gt.keys()) + list(by_key_dt.keys())):
            g = by_key_gt.get(key, [])
            d = by_key_dt.get(key, [])
            d = sorted(d, key=lambda x: -x["score"])[: MAX_DETS[-1]]
            crowd = [gg.get("iscrowd", 0) == 1 for gg in g]
            if self.iou_type == "bbox":
                iou_cache[key] = box_iou_xywh(
                    np.array([dd["bbox"] for dd in d], float).reshape(-1, 4),
                    np.array([gg["bbox"] for gg in g], float).reshape(-1, 4),
                    crowd,
                )
            else:
                iou_cache[key] = mask_iou_rle(
                    [dd["segmentation"] for dd in d], [gg["segmentation"] for gg in g], crowd
                )

        # accumulate precision[T, R, K, A, M]
        t_n, r_n, k_n = len(IOU_THRS), len(REC_THRS), len(cats)
        a_names = list(AREA_RNG)
        precision = -np.ones((t_n, r_n, k_n, len(a_names), len(MAX_DETS)))
        recall = -np.ones((t_n, k_n, len(a_names), len(MAX_DETS)))

        for ki, cat in enumerate(cats):
            for ai, a_name in enumerate(a_names):
                rng = AREA_RNG[a_name]
                for mi, max_det in enumerate(MAX_DETS):
                    evals = []
                    for img in imgs:
                        key = (img, cat)
                        g = by_key_gt.get(key, [])
                        d = sorted(by_key_dt.get(key, []), key=lambda x: -x["score"])[: MAX_DETS[-1]]
                        if not g and not d:
                            continue
                        e = _evaluate_img(
                            d, g, iou_cache.get(key, np.zeros((0, 0))), rng, max_det,
                            iou_type=self.iou_type,
                        )
                        if e is not None:
                            evals.append(e)
                    if not evals:
                        continue
                    scores = np.concatenate([e.dt_scores for e in evals]) if evals else np.zeros((0,))
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e.dt_matches for e in evals], axis=1)[:, order]
                    dt_ig = np.concatenate([e.dt_ignore for e in evals], axis=1)[:, order]
                    npig = sum(e.num_gt for e in evals)
                    if npig == 0:
                        continue
                    tps = (dtm == 1) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1)
                    fp_sum = np.cumsum(fps, axis=1)
                    for ti in range(t_n):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        recall[ti, ki, ai, mi] = rc[-1] if rc.size else 0.0
                        # monotone precision envelope
                        q = np.zeros(r_n)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        def _summ(ap=True, iou_thr=None, area="all", max_det=100):
            ai = a_names.index(area)
            mi = MAX_DETS.index(max_det)
            if ap:
                s = precision
                if iou_thr is not None:
                    s = s[[int(np.argmin(np.abs(IOU_THRS - iou_thr)))]]
                s = s[:, :, :, ai, mi]
            else:
                s = recall
                if iou_thr is not None:
                    s = s[[int(np.argmin(np.abs(IOU_THRS - iou_thr)))]]
                s = s[:, :, ai, mi]
            valid = s[s > -1]
            return float(valid.mean()) if valid.size else -1.0

        return {
            "AP": _summ(),
            "AP50": _summ(iou_thr=0.5),
            "AP75": _summ(iou_thr=0.75),
            "AP_small": _summ(area="small"),
            "AP_medium": _summ(area="medium"),
            "AP_large": _summ(area="large"),
            "AR1": _summ(ap=False, max_det=1),
            "AR10": _summ(ap=False, max_det=10),
            "AR100": _summ(ap=False, max_det=100),
            "AR_small": _summ(ap=False, area="small"),
            "AR_medium": _summ(ap=False, area="medium"),
            "AR_large": _summ(ap=False, area="large"),
        }
