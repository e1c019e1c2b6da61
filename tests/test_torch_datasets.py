"""PyTorch port's dataset preprocessing (`preprocess/datasets`,
`preprocess/refer_api`) against the JAX package's, on the CPU:
`patch_occupancy` (whose OpenCV uint8 resize the port does in numpy) gives
the same cells on random masks, and COCO OVD, RefCOCO and RIC processing
write the same JSONL rows and statistics on `tests/test_datasets.py`'s
synthetic COCO directory and on a synthetic REFER directory (a
`refs(unc).p` pickle beside an `instances.json` with polygon and RLE
segmentations). Exact equality throughout: the same arithmetic on the
same inputs."""

import json
import os
import pickle

import numpy as np
import pytest

from test_datasets import _mk_coco
from padt_tpu.eval import rle as jrle
from padt_tpu.preprocess import datasets as JD
from padt_tpu.preprocess import refer_api as JR
from padt_tpu_torch.preprocess import datasets as TD
from padt_tpu_torch.preprocess import refer_api as TR


@pytest.mark.parametrize("inclusive", [True, False])
def test_patch_occupancy_matches_jax(inclusive):
    rng = np.random.RandomState(0)
    sizes = [(112, 140), (57, 201), (300, 280), (43, 43), (29, 85), (644, 480)]
    n_some = 0
    for h, w in sizes:
        for kind in range(4):
            m = np.zeros((h, w), np.uint8)
            if kind == 0:
                m = (rng.rand(h, w) < 0.05).astype(np.uint8)  # sparse speckle: cells near the threshold
            elif kind == 1:
                y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
                m[y : y + rng.randint(1, h // 2), x : x + rng.randint(1, w // 2)] = 1
            elif kind == 2:
                m[rng.randint(h), rng.randint(w)] = 1
            else:
                m = (np.kron(rng.rand(h // 7 + 1, w // 7 + 1), np.ones((7, 7)))[:h, :w] > 0.6).astype(np.uint8)
            j, t = JD.patch_occupancy(m, inclusive), TD.patch_occupancy(m, inclusive)
            assert (j is None) == (t is None), (h, w, kind)
            if j is not None:
                np.testing.assert_array_equal(t, j)
                n_some += 1
    assert n_some >= 12


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("train", [False, True])
def test_process_coco_matches_jax(tmp_path, train):
    src = _mk_coco(tmp_path)
    kw = dict(is_train=train, seed=3) if train else {}
    js = JD.process_coco(src, str(tmp_path / "j.jsonl"), **kw)
    ts = TD.process_coco(src, str(tmp_path / "t.jsonl"), **kw)
    assert ts == js
    assert _rows(tmp_path / "t.jsonl") == _rows(tmp_path / "j.jsonl") and _rows(tmp_path / "t.jsonl")


def test_process_ric_matches_jax(tmp_path):
    src = _mk_coco(tmp_path, with_captions=True)
    js = JD.process_ric(src, str(tmp_path / "j.jsonl"))
    ts = TD.process_ric(src, str(tmp_path / "t.jsonl"))
    assert ts == js and _rows(tmp_path / "t.jsonl") == _rows(tmp_path / "j.jsonl")
    valid = [405710, 714044]
    for cap in ("(405710)", "<box_id: x714044/>", "<box_id: 405710/, 714044/>", "a (405710, 714044) b"):
        assert TD.repair_ric_caption(cap, valid) == JD.repair_ric_caption(cap, valid)


def mk_refer(root, dataset="refcoco", split_by="unc"):
    """A REFER directory: `<root>/<dataset>/refs(<split_by>).p` and
    `instances.json`, with polygon, RLE and tiny (skipped) segmentations."""
    rng = np.random.RandomState(4)
    base = os.path.join(root, dataset)
    os.makedirs(base)
    images, anns, refs = [], [], []
    for i in range(4):
        h, w = int(rng.randint(60, 200)), int(rng.randint(60, 200))
        images.append({"id": i + 1, "file_name": f"im{i}.jpg", "height": h, "width": w})
        for j in range(2):
            aid = 10 * (i + 1) + j
            x, y = float(rng.randint(0, w // 2)), float(rng.randint(0, h // 2))
            bw, bh = float(rng.randint(8, w // 2)), float(rng.randint(8, h // 2))
            if j == 0:
                seg = [[x, y, x + bw, y, x + bw * 0.7, y + bh, x, y + bh * 0.8]]
            else:
                m = np.zeros((h, w), np.uint8)
                m[int(y) : int(y + bh), int(x) : int(x + bw)] = 1
                if i == 3:  # one pixel: no cell passes, the row is skipped
                    m[:] = 0
                    m[int(y), int(x)] = 1
                seg = jrle.encode(m)
            anns.append({"id": aid, "image_id": i + 1, "category_id": 1, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0, "segmentation": seg})
            refs.append({"ref_id": aid, "ann_id": aid, "image_id": i + 1, "split": "val" if i % 2 == 0 else "train",
                         "sentences": [{"sent": f"thing {aid} on the left"}, {"sent": f"the {j}th thing"}]})
    refs.append({"ref_id": 999, "ann_id": 12345, "image_id": 1, "split": "val", "sentences": [{"sent": "gone"}]})
    with open(os.path.join(base, f"refs({split_by}).p"), "wb") as f:
        pickle.dump(refs, f)
    with open(os.path.join(base, "instances.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "thing"}]}, f)
    return root


@pytest.mark.parametrize("split", ["val", "train"])
def test_refcoco_matches_jax(tmp_path, split):
    root = mk_refer(str(tmp_path / "data"))
    assert list(TR.ReferDataset(root).iter_items(split)) == list(JR.ReferDataset(root).iter_items(split))
    js = JR.process_refcoco(root, "refcoco", split, str(tmp_path / "j.jsonl"))
    ts = TR.process_refcoco(root, "refcoco", split, str(tmp_path / "t.jsonl"))
    assert ts == js and ts["rows"] > 0
    assert _rows(tmp_path / "t.jsonl") == _rows(tmp_path / "j.jsonl")
