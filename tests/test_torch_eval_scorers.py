"""PyTorch port's scorers against the JAX package's, on the CPU: the port's
`COCOEvaluator` (bbox and segm) and `score_refcoco` give `==` the JAX
results on the inputs of `tests/test_eval.py` and
`tests/test_eval_segm_oracle.py` (their fixed scenes and seeded fuzz), and
agree with the straight-line COCOeval transcription of
`tests/cocoeval_reference.py` within 1e-9, as JAX's do. `score_refcoco`'s
mask resize (OpenCV's uint8 INTER_LINEAR, done in numpy by
`utils.resize.resize_linear_u8`) equals `cv2.resize` bit for bit."""

import numpy as np
import pytest

import cv2

from cocoeval_reference import cocoeval_bbox, cocoeval_segm
from test_eval_segm_oracle import _random_mask, _scene
from padt_tpu.eval import rle as jrle
from padt_tpu.eval.coco_map import COCOEvaluator as JEval, box_iou_xywh as j_box_iou
from padt_tpu.eval.refcoco_eval import score_refcoco as j_score
from padt_tpu_torch.eval import coco_map as TC
from padt_tpu_torch.eval.refcoco_eval import score_refcoco as t_score
from padt_tpu_torch.train.data import resize_linear
from padt_tpu_torch.utils.resize import resize_linear_u8


def _gt(img, cat, box, area=None, crowd=0, seg=None):
    d = {"image_id": img, "category_id": cat, "bbox": list(box),
         "area": area if area is not None else box[2] * box[3], "iscrowd": crowd}
    if seg:
        d["segmentation"] = seg
    return d


def _dt(img, cat, box, score, seg=None):
    d = {"image_id": img, "category_id": cat, "bbox": list(box), "score": score}
    if seg:
        d["segmentation"] = seg
    return d


def _fixed_bbox_scenes():
    """The hand-built scenes of `tests/test_eval.py` (bbox)."""
    return [
        ([_gt(1, 1, (10, 10, 50, 50)), _gt(1, 2, (30, 30, 40, 40)), _gt(2, 1, (0, 0, 20, 20))],
         [_dt(1, 1, (10, 10, 50, 50), 0.9), _dt(1, 2, (30, 30, 40, 40), 0.8), _dt(2, 1, (0, 0, 20, 20), 0.7)]),
        ([_gt(1, 1, (10, 10, 50, 50)), _gt(1, 1, (100, 100, 50, 50))],
         [_dt(1, 1, (10, 10, 50, 50), 0.9), _dt(1, 1, (200, 200, 10, 10), 0.5)]),
        ([_gt(1, 1, (0, 0, 100, 100))], [_dt(1, 1, (0, 0, 100, 60), 0.9)]),
        ([_gt(1, 1, (0, 0, 50, 50)), _gt(1, 1, (60, 0, 1000, 50), area=50000, crowd=1)],
         [_dt(1, 1, (0, 0, 50, 50), 0.9), _dt(1, 1, (60, 0, 100, 50), 0.8)]),
        ([_gt(1, 1, (0, 0, 10, 10)), _gt(2, 1, (0, 0, 10, 10))],
         [_dt(1, 1, (50, 50, 10, 10), 0.5), _dt(2, 1, (0, 0, 10, 10), 0.5), _dt(1, 1, (0, 0, 10, 10), 0.9)]),
        ([_gt(1, 1, (0, 0, 10, 10)), _gt(1, 1, (100, 100, 50, 50), crowd=1)],
         [_dt(1, 1, (0, 0, 10, 10), 0.9), _dt(1, 1, (100, 100, 50, 50), 0.8), _dt(1, 1, (110, 110, 40, 40), 0.7)]),
        ([_gt(1, 1, (0, 0, 20, 20))], [_dt(1, 1, (0, 0, 20, 20), 0.9), _dt(1, 2, (5, 5, 10, 10), 0.8)]),
        ([_gt(1, 1, (0, 0, 10, 10))],
         [_dt(1, 1, (200 + 15 * i, 200, 10, 10), 0.9 - 0.01 * i) for i in range(10)] + [_dt(1, 1, (0, 0, 10, 10), 0.1)]),
        ([_gt(1, 1, (0, 0, 10, 10)), _gt(1, 1, (100, 100, 50, 50))],
         [_dt(1, 1, (0, 0, 10, 10), 0.9), _dt(1, 1, (100, 100, 50, 50), 0.8)]),
        ([_gt(1, 1, (0, 0, 10, 10))], [_dt(1, 1, (0, 0, 10, 10), 0.5), _dt(1, 1, (300, 300, 50, 50), 0.9)]),
        ([_gt(1, 1, (0, 0, 10, 10)), _gt(1, 1, (50, 50, 10, 10)), _gt(1, 1, (200, 0, 10, 10))],
         [_dt(1, 1, (0, 0, 10, 10), 0.9), _dt(1, 1, (400, 400, 5, 5), 0.8), _dt(1, 1, (50, 50, 10, 10), 0.7),
          _dt(1, 1, (420, 420, 5, 5), 0.6)]),
    ]


def _fuzz_bbox_scenes():
    """`test_fuzz_against_reference_transcription`'s seeded scenes."""
    rng = np.random.RandomState(7)
    score_grid = [0.2, 0.4, 0.6, 0.8]
    out = []
    for _ in range(25):
        n_img, n_cat = rng.randint(1, 4), rng.randint(1, 3)
        gts, dts = [], []
        for img in range(1, n_img + 1):
            for cat in range(1, n_cat + 1):
                for _ in range(rng.randint(0, 4)):
                    x, y = rng.randint(0, 200, 2)
                    w, h = rng.randint(4, 120, 2)
                    gts.append(_gt(img, cat, (x, y, w, h), crowd=int(rng.rand() < 0.2)))
                for _ in range(rng.randint(0, 6)):
                    x, y = rng.randint(0, 200, 2)
                    w, h = rng.randint(4, 120, 2)
                    dts.append(_dt(img, cat, (x, y, w, h), float(rng.choice(score_grid))))
        if not gts and not dts:
            continue
        for g in gts[::2]:
            dts.append(_dt(g["image_id"], g["category_id"], g["bbox"], float(rng.choice(score_grid))))
        out.append((gts, dts))
    return out


def _same(ours, theirs):
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k] == v or (np.isnan(ours[k]) and np.isnan(v)), (k, ours[k], v)


@pytest.mark.parametrize("which", ["fixed", "fuzz"])
def test_bbox_map_equals_jax(which):
    scenes = _fixed_bbox_scenes() if which == "fixed" else _fuzz_bbox_scenes()
    assert len(scenes) >= 11
    for gts, dts in scenes:
        ours = TC.COCOEvaluator("bbox").evaluate(gts, dts)
        _same(ours, JEval("bbox").evaluate(gts, dts))
        ref = cocoeval_bbox(gts, dts)
        for k in ref:
            assert abs(ours[k] - ref[k]) < 1e-9, (k, ours[k], ref[k])
    d, g = np.array([[0, 0, 10, 10.]]), np.array([[0, 0, 10, 10.], [5, 5, 10, 10.]])
    np.testing.assert_array_equal(TC.box_iou_xywh(d, g, [False, True]), j_box_iou(d, g, [False, True]))


def test_segm_map_equals_jax():
    a = np.zeros((50, 50), np.uint8)
    a[10:40, 10:40] = 1
    seg = jrle.encode(a)
    scenes = [([_gt(1, 1, (10, 10, 30, 30), seg=seg)], [_dt(1, 1, (10, 10, 30, 30), 0.9, seg=seg)])]
    rng = np.random.RandomState(37)
    for _ in range(12):
        h, w = rng.randint(20, 80), rng.randint(20, 80)
        gts, dts = _scene(rng, rng.randint(1, 3), rng.randint(1, 3), h, w)
        if gts or dts:
            scenes.append((gts, dts))
    assert len(scenes) >= 9
    for gts, dts in scenes:
        ours = TC.COCOEvaluator("segm").evaluate(gts, dts)
        _same(ours, JEval("segm").evaluate(gts, dts))
        ref = cocoeval_segm(gts, dts)
        for k in ref:
            assert abs(ours[k] - ref[k]) < 1e-9, (k, ours[k], ref[k])


def _refcoco_scene(seed, h, w, pred_hw=None):
    """`test_ciou_vs_independent_accumulation`'s scene; with pred_hw the
    predicted masks are drawn at another size, so the scorer resizes them."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for i in range(12):
        g_rle = jrle.encode(_random_mask(rng, h, w))
        label = f"obj {i}"
        gts.append({"image_id": i, "label": label, "bbox": jrle.to_bbox(g_rle), "rle": g_rle})
        for _ in range(rng.randint(0, 3)):
            ph, pw = pred_hw or (h, w)
            pm = _random_mask(rng, ph, pw)
            p_rle = jrle.encode(pm)
            bx = jrle.to_bbox(p_rle)
            if pred_hw:  # the box in the GT's frame, so the IoU ranking still means something
                sx, sy = w / pw, h / ph
                bx = (bx[0] * sx, bx[1] * sy, bx[2] * sx, bx[3] * sy)
            preds.append({"image_id": i, "category": label, "bbox": bx, "score": float(rng.rand()), "mask": p_rle})
    return gts, preds


@pytest.mark.parametrize("pred_hw", [None, (37, 53), (24, 32), (96, 128), (61, 17)])
def test_score_refcoco_equals_jax(pred_hw):
    m = np.zeros((100, 100), np.uint8)
    m[20:60, 20:60] = 1
    gts = [{"image_id": 1, "label": "red car", "bbox": (20, 20, 40, 40), "rle": jrle.encode(m)},
           {"image_id": 2, "label": "dog", "bbox": (0, 0, 50, 50)}]
    preds = [{"image_id": 1, "category": "red car", "bbox": (22, 22, 38, 38), "score": 0.9, "mask": jrle.encode(m)},
             {"image_id": 2, "category": "dog", "bbox": (60, 60, 10, 10), "score": 0.8}]
    assert t_score(gts, preds) == j_score(gts, preds)
    gts, preds = _refcoco_scene(51, 48, 64, pred_hw)
    ours = t_score(gts, preds)
    assert ours == j_score(gts, preds)
    assert ours["num_gt"] == 12 and 0.0 < ours["ciou"] < 1.0


def test_resize_u8_equals_cv2_bit_for_bit():
    """Random 0/1 masks (and 0/255 and full-range images) at up- and
    down-scales, odd sizes, exact 2x factors both ways, 1-pixel edges."""
    rng = np.random.RandomState(5)
    sizes = [((37, 53), (61, 89)), ((100, 120), (47, 59)), ((64, 64), (128, 128)), ((50, 50), (25, 25)),
             ((56, 84), (28, 42)), ((81, 9), (40, 5)), ((7, 13), (29, 3)), ((1, 1), (5, 7)), ((5, 7), (1, 1)),
             ((3, 100), (9, 37)), ((33, 70), (31, 140)), ((2, 2), (1, 1))]
    for _ in range(60):
        h, w = rng.randint(1, 90, 2)
        sizes.append(((int(h), int(w)), tuple(int(x) for x in rng.randint(1, 180, 2))))
    for (h, w), (dh, dw) in sizes:
        for kind in ("01", "0255", "full"):
            if kind == "full":
                src = rng.randint(0, 256, (h, w)).astype(np.uint8)
            else:
                src = (rng.rand(h, w) < 0.4).astype(np.uint8) * (255 if kind == "0255" else 1)
            want = cv2.resize(src, (dw, dh))
            got = resize_linear_u8(src, (dw, dh))
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str(((h, w), (dh, dw), kind)))


def test_float_resize_would_change_the_masks():
    """Why the scorer does not reuse the float32 `resize_linear`: thresholded
    at > 0, a 0/1 mask's float resize keeps pixels whose weight rounds to 0
    in OpenCV's uint8 arithmetic."""
    rng = np.random.RandomState(9)
    src = (rng.rand(37, 53) < 0.3).astype(np.uint8)
    want = cv2.resize(src, (89, 61)) > 0
    assert np.array_equal(resize_linear_u8(src, (89, 61)) > 0, want)
    assert not np.array_equal(resize_linear(src.astype(np.float32), (89, 61)) > 0, want)
