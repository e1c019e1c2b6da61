"""COCO run-length-encoded (RLE) mask codec + mask utilities (the port's copy
of `padt_tpu/eval/rle.py`, numpy codec only).

Replaces pycocotools' C `_mask` module (a load-bearing native dep of the
reference: RLE encode/decode at `padt_sft_trainer.py:36,498`, `utils.py:264`,
scoring at `eval_coco.py:84-90` — SURVEY.md §2.3). Implements the standard COCO
compressed-counts string format (5-bit groups, 0x30 offset, delta-coded runs,
column-major masks). The original's optional native accelerator gives the
same output and is left out.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# counts <-> compressed string (maskApi rleToString/rleFrString format)
# ---------------------------------------------------------------------------

def counts_to_string(counts: Sequence[int]) -> str:
    s = []
    for i in range(len(counts)):
        x = int(counts[i])
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def string_to_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


# ---------------------------------------------------------------------------
# mask <-> RLE
# ---------------------------------------------------------------------------

def encode(mask: np.ndarray) -> Dict:
    """Binary mask (H, W) -> {'size': [H, W], 'counts': str}. Column-major runs
    starting with a zero-run (pycocotools semantics)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    # run lengths
    if flat.size == 0:
        return {"size": [h, w], "counts": counts_to_string([0])}
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(idx).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": counts_to_string(runs)}


def decode(rle: Dict) -> np.ndarray:
    """{'size': [H, W], 'counts': str|list} -> (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    if flat.size < h * w:
        flat = np.pad(flat, (0, h * w - flat.size))
    return flat[: h * w].reshape((h, w), order="F")


def area(rle: Dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    return int(sum(counts[1::2]))


def to_bbox(rle: Dict) -> Tuple[float, float, float, float]:
    """RLE -> (x, y, w, h)."""
    m = decode(rle)
    ys, xs = np.nonzero(m)
    if xs.size == 0:
        return (0.0, 0.0, 0.0, 0.0)
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    return (float(x0), float(y0), float(x1 - x0 + 1), float(y1 - y0 + 1))


def mask_iou(a: Dict, b: Dict, iscrowd: bool = False) -> float:
    """IoU of two RLE masks (pycocotools iou() semantics:
    iscrowd -> intersection / area(a))."""
    ma = decode(a).astype(bool)
    mb = decode(b).astype(bool)
    inter = np.logical_and(ma, mb).sum()
    if iscrowd:
        den = ma.sum()
    else:
        den = np.logical_or(ma, mb).sum()
    return float(inter) / float(den) if den > 0 else 0.0


def merge(rles: Sequence[Dict], intersect: bool = False) -> Dict:
    if not rles:
        raise ValueError("empty rle list")
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        n = decode(r).astype(bool)
        m = np.logical_and(m, n) if intersect else np.logical_or(m, n)
    return encode(m.astype(np.uint8))


def poly_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Polygon(s) [x0,y0,x1,y1,...] -> (H, W) uint8 mask.

    Uses cv2 scanline fill; pycocotools' maskApi upsamples by 5 before
    rasterizing, so boundaries may differ by <=1px (acceptable for training
    target generation; documented divergence)."""
    import cv2

    mask = np.zeros((h, w), np.uint8)
    pts = [np.round(np.asarray(p, np.float64)).reshape(-1, 2).astype(np.int32) for p in polygons if len(p) >= 6]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def ann_to_mask(ann: Dict, h: int, w: int) -> np.ndarray:
    """COCO annotation -> binary mask (pycocotools COCO.annToMask semantics)."""
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return poly_to_mask(seg, h, w)
    if isinstance(seg.get("counts"), list):
        return decode({"size": seg["size"], "counts": seg["counts"]})
    return decode(seg)
