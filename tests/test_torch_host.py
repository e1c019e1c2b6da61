"""The port's copies of the JAX package's framework-neutral host modules
(config, VRT processor and parser, image preprocessing, vision geometry,
M-RoPE index, mock tokenizer, RLE codec) give exactly what their originals
give on the same inputs."""

import dataclasses

import numpy as np
import pytest

from test_torch_common import port_image, seeded_image, tiny_processor, torch_cfg
from padt_tpu import config as JC
from padt_tpu.eval import rle as JR
from padt_tpu.models import mrope_index as JM
from padt_tpu.models import vision_geom as JG
from padt_tpu.preprocess import vision_process as JV
from padt_tpu.utils import mock_tokenizer as JT
from padt_tpu.vrt import parser as JPa
from padt_tpu_torch import config as TC
from padt_tpu_torch.eval import rle as TR
from padt_tpu_torch.models import mrope_index as TM
from padt_tpu_torch.models import vision_geom as TG
from padt_tpu_torch.preprocess import vision_process as TV
from padt_tpu_torch.utils import mock_tokenizer as TT
from padt_tpu_torch.vrt import parser as TPa


def _same(a, b, what=""):
    """Equal values of equal types, through dataclasses, dicts and sequences."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b and type(a) is type(b), (what, a, b)


@pytest.mark.parametrize("preset", ["padt_3b", "padt_7b", "padt_tiny"])
def test_config_presets_match(preset):
    j, t = getattr(JC, preset)(), getattr(TC, preset)()
    assert t.to_json() == j.to_json()
    assert torch_cfg(j) == t
    assert t.max_merged_patches == j.max_merged_patches and t.vision.head_dim == j.vision.head_dim


@pytest.mark.parametrize("u8", [False, True])
def test_processor_batches_match(u8):
    """Token ids, attention masks, position ids, rope deltas and pixel rows
    of a batch over two images, and a shared-prefix batch with its suffix."""
    cfg = JC.padt_tiny()
    jproc, tproc = tiny_processor(cfg), tiny_processor(torch_cfg(cfg))
    imgs = [seeded_image((1, 8, 12), 3, u8), seeded_image((1, 12, 16), 4, u8)]
    prompts = ['find "the red car"', 'where is "the dog"?']
    jb = jproc.build_batch(prompts, imgs, patch_bucket=cfg.max_image_patches)
    tb = tproc.build_batch(prompts, [port_image(i) for i in imgs], patch_bucket=cfg.max_image_patches)
    _same(jb.data, tb.data, "data")
    _same(jb.rope_deltas, tb.rope_deltas, "rope_deltas")
    assert ("pixel_patches_u8" in tb.data) == u8
    jp = jproc.build_prefix_batch(imgs[0], prefix_bucket=96, patch_bucket=128)
    tp = tproc.build_prefix_batch(port_image(imgs[0]), prefix_bucket=96, patch_bucket=128)
    _same(jp.data, tp.data, "prefix")
    assert tproc.build_suffix_ids(prompts[0]) == jproc.build_suffix_ids(prompts[0])
    assert tproc.pid2vrt([3, 7]) == jproc.pid2vrt([3, 7])


def test_image_preprocessing_matches():
    import PIL.Image

    img = PIL.Image.fromarray(np.random.RandomState(0).randint(0, 256, (70, 131, 3)).astype(np.uint8))
    for u8 in (False, True):
        _same(JV.process_image(img, u8_rows=u8), TV.process_image(img, u8_rows=u8), f"u8={u8}")
    rows = np.random.RandomState(1).randint(0, 256, (12, 588)).astype(np.uint8)
    _same(JV.expand_u8_rows(rows), TV.expand_u8_rows(rows))
    small = PIL.Image.fromarray(np.zeros((10, 700, 3), np.uint8))
    assert TV.ensure_min_28(small).size == JV.ensure_min_28(small).size
    assert TV.resize_max_side(small, 644).size == JV.resize_max_side(small, 644).size


@pytest.mark.parametrize("slots", [True, False])
def test_vision_geometry_matches(slots):
    grids = [(1, 8, 12), (1, 16, 16), (1, 20, 28)]
    _same(JG.vision_geometry(grids, 768, window_slots=slots), TG.vision_geometry(grids, 768, window_slots=slots))


def test_rope_index_matches():
    """An image row, a text-only row and a video row."""
    cfg = JC.padt_tiny()
    r = np.random.RandomState(2)
    ids = r.randint(0, 100, (3, 40))
    mask = np.ones((3, 40), np.int64)
    mask[1, :6] = 0
    ids[0, 5:5 + 6] = cfg.image_token_id  # (1, 4, 6) grid -> 6 merged
    ids[2, 8:8 + 8] = cfg.video_token_id  # (2, 4, 4) grid -> 8 merged
    grid = np.array([[1, 4, 6], [0, 0, 0], [2, 4, 4]])
    kw = dict(video_token_id=cfg.video_token_id, second_per_grid_ts=[0.0, 0.0, 1.0])
    j = JM.get_rope_index(ids, mask, grid, cfg.image_token_id, **kw)
    t = TM.get_rope_index(ids, mask, grid, cfg.image_token_id, **kw)
    _same(j, t)


def test_mock_tokenizer_and_parser_match():
    cfg = JC.padt_tiny()
    jt, tt = JT.make_tiny_tokenizer(cfg), TT.make_tiny_tokenizer(torch_cfg(cfg))
    text = 'find "x" <|im_end|> ok'
    assert tt.encode(text) == jt.encode(text) and tt.decode(jt.encode(text)) == jt.decode(jt.encode(text))
    jproc, tproc = tiny_processor(cfg), tiny_processor(torch_cfg(cfg))
    v = cfg.text.vocab_size
    for p in (jproc, tproc):
        p.ensure_vrt_tokens(16)
    rows = [jproc.encode('"a cat" ') + [v + 3, v + 4] + jproc.encode(' and "b" ') + [v + 9], jproc.encode("nothing here")]
    n = max(map(len, rows))
    ids = np.array([r + [0] * (n - len(r)) for r in rows])
    strs = [jproc.token_strings(row) for row in ids]
    assert strs == [tproc.token_strings(row) for row in ids]
    j, t = JPa.parse_vrt_completions(strs, ids, v), TPa.parse_vrt_completions(strs, ids, v)
    _same(j, t)
    assert sum(len(o) for o in t.objects_per_sample) == 2
    _same(JPa.pack_objects(j.all_objects, 4, 3), TPa.pack_objects(t.all_objects, 4, 3))


def test_rle_matches():
    r = np.random.RandomState(3)
    masks = [(r.rand(37, 53) > 0.6).astype(np.uint8), np.zeros((8, 5), np.uint8), np.ones((4, 9), np.uint8)]
    for m in masks:
        je, te = JR.encode(m), TR.encode(m)
        assert te == je
        np.testing.assert_array_equal(TR.decode(je), JR.decode(je))
        assert TR.area(je) == JR.area(je) and TR.to_bbox(je) == JR.to_bbox(je)
    a, b = JR.encode(masks[0]), JR.encode((r.rand(37, 53) > 0.5).astype(np.uint8))
    for crowd in (False, True):
        assert TR.mask_iou(a, b, crowd) == pytest.approx(JR.mask_iou(a, b, crowd), abs=0)
    assert TR.merge([a, b]) == JR.merge([a, b]) and TR.merge([a, b], intersect=True) == JR.merge([a, b], intersect=True)
    assert TR.string_to_counts(a["counts"]) == JR.string_to_counts(a["counts"])


# ---------------------------------------------------------------------------
# training host modules: train/data.py and train/prefetch.py
# ---------------------------------------------------------------------------


def _train_samples(rle_mod, n=3, h=112, w=98):
    """Dataset rows (one object each, with a box, patch ids and an RLE
    mask) and float-row images of (1, 8, 6) patches."""
    r = np.random.RandomState(4)
    rows = []
    for i in range(n):
        m = np.zeros((h, w), np.uint8)
        m[10 + 3 * i : 70, 14 : 60 - 2 * i] = 1
        rows.append({
            "id": i, "image_path": [], "problem": f'find "thing {i}"',
            "solution": {"text": f'The "thing {i}" is <|Obj_0|> here.',
                         "objects": [{"patches": [1, 2, 5, 6, 7 + i], "bbox": [0.1, 0.1, 0.6, 0.7], "rle": rle_mod.encode(m)}]},
        })
    return rows, r


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("random_select", [False, True])
def test_build_train_batch_matches(u8, random_select):
    """The same rows, images and seed give the same batch: token ids, VRT
    penalty masks, object index arrays, boxes and the resized mask targets
    (the port resizes them in numpy, the original with OpenCV). The original
    reads only float pixel rows; with uint8 rows it is held to the port's
    float-row batch."""
    from padt_tpu.train import data as JD
    from padt_tpu_torch.train import data as TD

    cfg = JC.padt_tiny()
    jproc, tproc = tiny_processor(cfg), tiny_processor(torch_cfg(cfg))
    rows, _ = _train_samples(JR)
    imgs = [seeded_image((1, 8, 6), 10 + i, False) for i in range(len(rows))]
    kw = dict(prompt_bucket=128, completion_bucket=32, patch_bucket=cfg.max_image_patches, canvas_hw=(8, 8),
              random_select_patch=random_select, random_select_patch_num=3, batch_idx=[0, 1, 2])
    jb = JD.build_train_batch(rows, jproc, cfg, np.random.RandomState(7), images=imgs, **kw)
    timgs = [port_image(seeded_image((1, 8, 6), 10 + i, True)) for i in range(len(rows))] if u8 else [port_image(i) for i in imgs]
    tb = TD.build_train_batch(rows, tproc, torch_cfg(cfg), np.random.RandomState(7), images=timgs, **kw)
    jd, td = dict(jb.model), dict(tb.model)
    if u8:
        jd.pop("pixel_patches")
        np.testing.assert_array_equal(JV.expand_u8_rows(td.pop("pixel_patches_u8")[0, :48]), imgs[0].pixel_patches)
    _same(jd, td, "model")
    _same(jb.meta, tb.meta, "meta")
    assert tb.prompt_length == jb.prompt_length and td["gt_mask"].sum() > 0
    np.testing.assert_array_equal(tb.rope_deltas, jb.rope_deltas)


def test_resize_linear_matches_cv2():
    """`resize_linear` vs cv2.resize (INTER_LINEAR, float32): up- and
    downscales, an exact 2x downscale (OpenCV's area path), binary masks and
    noise. Values within 1e-6 (OpenCV's SIMD path may fuse a multiply-add),
    and the thresholded mask targets identical."""
    import cv2

    from padt_tpu_torch.train.data import resize_linear

    r = np.random.RandomState(0)
    shapes = [(112, 112, (32, 32)), (112, 112, (56, 56)), (644, 644, (184, 184)), (480, 640, (184, 136)),
              (37, 53, (100, 80)), (300, 200, (64, 96)), (50, 50, (200, 200)), (97, 131, (48, 32)), (427, 640, (184, 124))]
    for h, w, dsize in shapes:
        box = np.zeros((h, w), np.float32)
        box[h // 5 : h // 2, w // 7 : (3 * w) // 4] = 1.0
        for m in (box, (r.rand(h, w) > 0.6).astype(np.float32), r.rand(h, w).astype(np.float32)):
            a, b = cv2.resize(m, dsize), resize_linear(m, dsize)
            assert a.shape == b.shape == (dsize[1], dsize[0]) and b.dtype == np.float32
            assert np.abs(a - b).max() <= 1e-6, (h, w, dsize)
            np.testing.assert_array_equal(a > 0.5, b > 0.5)


def test_synthesis_and_sampler_match():
    from padt_tpu.train import data as JD
    from padt_tpu.train import trainer as JTr
    from padt_tpu_torch.train import data as TD
    from padt_tpu_torch.train import trainer as TTr

    cfg = JC.padt_tiny()
    jproc, tproc = tiny_processor(cfg), tiny_processor(torch_cfg(cfg))
    rows, _ = _train_samples(JR)
    for rand in (False, True):
        for k in (5, -1, 2):
            a = JD.synthesize_completion(rows[1]["solution"], 6, jproc, np.random.RandomState(3), random_select_patch=rand, random_select_patch_num=k)
            b = TD.synthesize_completion(rows[1]["solution"], 6, tproc, np.random.RandomState(3), random_select_patch=rand, random_select_patch_num=k)
            assert a.completion == b.completion
            _same(a.objects, b.objects)
    for args in ((10, 4, 0), (9, 2, 5, 2, 1, 3), (8, 4, 1, 1, 2, 2)):
        assert list(TTr.repeat_random_sampler(*args)) == list(JTr.repeat_random_sampler(*args))


def test_prefetch_copy_matches():
    from padt_tpu.train.prefetch import BatchPrefetcher as JB
    from padt_tpu_torch.train.prefetch import BatchPrefetcher as TB

    assert list(TB(iter(range(7)), depth=2)) == list(JB(iter(range(7)), depth=2)) == list(range(7))

    def bad():
        yield 1
        raise KeyError("boom")

    for cls in (JB, TB):
        it = cls(bad(), depth=1)
        assert next(it) == 1
        with pytest.raises(KeyError):
            next(it)
