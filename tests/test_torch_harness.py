"""PyTorch port `InferenceEngine.run_batch` vs the JAX engine on the CPU
(padt_tiny, float32): completions and pixel boxes equal, scores within 1e-4,
masks equal except where the upsampled logit is within 1e-4 of 0.

The JAX engine runs with compact_pixels=False: its run_batch keys its
compile cache on `pixel_patches`, which the compact uint8 format does not
carry. The port accepts both formats."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import port_image, seeded_image, tiny_params, tiny_processor, torch_cfg
from padt_tpu.eval import rle as rle_codec
from padt_tpu.eval.harness import InferenceEngine as JaxEngine
from padt_tpu.eval.harness import infer_dataset as JaxInferDataset
from padt_tpu_torch.convert.from_jax import params_from_numpy
from padt_tpu_torch.eval import harness as TH
from padt_tpu_torch.models import padt as TP


def test_upsample_matches_cv2_linear():
    cv2 = pytest.importorskip("cv2")
    r = np.random.RandomState(0)
    for h, w, H, W in [(32, 48, 100, 157), (64, 64, 30, 20), (8, 12, 8, 12)]:
        logit = r.randn(h, w).astype(np.float32)
        ref = cv2.resize(logit, (W, H), interpolation=cv2.INTER_LINEAR)
        # cv2 rounds its interpolation weights; 1e-4 is the mask test's margin
        np.testing.assert_allclose(TH.upsample_logits(logit, W, H), ref, atol=1e-4)


def test_run_batch_matches_jax_engine(monkeypatch):
    cfg, jp, _ = tiny_params(4)
    # a non-zero prototype LayerNorm (it is zero-initialized) makes VRT
    # logits dominate, so the completions carry objects for the decoder
    jp["proto"]["ln_w"] = jnp.ones_like(jp["proto"]["ln_w"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    grids = [(1, 8, 12), (1, 12, 16)]
    images = [seeded_image(g, i, u8=False) for i, g in enumerate(grids)]
    sizes = [(181, 117), (224, 170)]
    prompts = ['find "x"', 'find "the dog"']

    jres = JaxEngine(jp, cfg, tiny_processor(cfg), max_new_tokens=6, canvas_hw=(17, 17), compact_pixels=False).run_batch(
        prompts, images, image_sizes=sizes
    )
    ups = []
    real = TH.upsample_logits
    monkeypatch.setattr(TH, "upsample_logits", lambda *a: ups.append(real(*a)) or ups[-1])
    tcfg = torch_cfg(cfg)
    tres = TH.InferenceEngine(tp, tcfg, tiny_processor(tcfg), max_new_tokens=6, canvas_hw=(17, 17)).run_batch(
        prompts, [port_image(im) for im in images], image_sizes=sizes
    )
    assert sum(len(r.objects) for r in jres) > 0
    assert len(ups) == sum(len(r.objects) for r in tres)
    oi = 0
    for jr, tr in zip(jres, tres):
        assert tr.completion == jr.completion
        assert len(tr.objects) == len(jr.objects)
        for jo, to in zip(jr.objects, tr.objects):
            assert (to.label, to.vrt_string, to.bbox_xywh_px) == (jo.label, jo.vrt_string, jo.bbox_xywh_px)
            assert abs(to.score - jo.score) <= 1e-4
            jm, tm = rle_codec.decode(jo.mask_rle), rle_codec.decode(to.mask_rle)
            assert jm.shape == tm.shape
            assert np.all((jm == tm) | (np.abs(ups[oi]) < 1e-4))
            oi += 1


def test_run_batch_on_packed_weights_matches_jax_engine():
    """run_batch on `pack_inference_params` weights (fused qkv / gateup, as
    the serve engine leaves them) gives the JAX engine's completions and
    boxes on its unpacked weights."""
    cfg, jp, _ = tiny_params(4)
    jp["proto"]["ln_w"] = jnp.ones_like(jp["proto"]["ln_w"])
    tp = TP.pack_inference_params(params_from_numpy(jax.tree.map(np.asarray, jp)))
    images = [seeded_image((1, 8, 12), 5 + i, u8=False) for i in range(2)]
    prompts = ['find "x"', 'where is "the cat"']
    kw = dict(max_new_tokens=6, canvas_hw=(17, 17), compute_mask=False)
    jres = JaxEngine(jp, cfg, tiny_processor(cfg), compact_pixels=False, **kw).run_batch(prompts, images)
    tcfg = torch_cfg(cfg)
    tres = TH.InferenceEngine(tp, tcfg, tiny_processor(tcfg), **kw).run_batch(prompts, [port_image(im) for im in images])
    assert sum(len(r.objects) for r in jres) > 0
    for jr, tr in zip(jres, tres):
        assert tr.completion == jr.completion
        assert [(o.label, o.bbox_xywh_px) for o in tr.objects] == [(o.label, o.bbox_xywh_px) for o in jr.objects]


def test_raw_images_follow_the_engine_wire_format_and_leave_the_processor_alone():
    import PIL.Image

    cfg, _, tp = tiny_params(4)
    cfg = torch_cfg(cfg)
    proc = tiny_processor(cfg)
    img = PIL.Image.fromarray(np.random.RandomState(0).randint(0, 255, (64, 96, 3), np.uint8))
    out = {}
    for compact in (True, False):
        engine = TH.InferenceEngine(tp, cfg, proc, max_new_tokens=4, canvas_hw=(17, 17), compact_pixels=compact)
        out[compact] = engine.run_batch(['find "x"'], [img])
        assert proc.u8_pixels is False
    # both wire formats expand to the same bf16 pixels, so the same completion
    assert out[True][0].completion == out[False][0].completion


@pytest.mark.parametrize("stream,share", [(False, False), (True, False), (True, True)])
def test_infer_dataset_matches_jax(tmp_path, stream, share):
    """infer_dataset over PNG files (4 rows, 3 images, a partial last batch)
    writes the JAX package's two JSONL files with the same rows: completions,
    labels and pixel boxes equal, scores within 1e-4; fixed batches
    (run_batch) and the serve engine (run_stream, with and without shared
    image prefixes)."""
    import json

    import PIL.Image

    cfg, jp, _ = tiny_params(4)
    jp["proto"]["ln_w"] = jnp.ones_like(jp["proto"]["ln_w"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.RandomState(9)
    paths = []
    for i, (w, h) in enumerate([(168, 112), (140, 112), (168, 112)]):
        paths.append(str(tmp_path / f"img{i}.png"))
        PIL.Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(paths[-1])
    rows = [
        {"id": 1, "image_path": paths[0], "problem": 'find "a"'},
        {"id": 2, "image_path": [paths[1]], "problem": 'find "b"'},
        {"id": 3, "image_path": paths[0], "problem": "what is it"},
        {"id": 4, "image_path": paths[2], "problem": 'find "c"'},
    ]
    kw = dict(max_new_tokens=6, canvas_hw=(9, 9), compute_mask=False, compact_pixels=False)
    run = dict(batch_size=3, prompt_bucket=128, stream=stream, share_prefix=share, n_slots=2, prefill_bucket=1, chunk_steps=3)
    jfiles = JaxInferDataset(JaxEngine(jp, cfg, tiny_processor(cfg), **kw), rows, str(tmp_path / "jax"), **run)
    tcfg = torch_cfg(cfg)
    tfiles = TH.infer_dataset(TH.InferenceEngine(tp, tcfg, tiny_processor(tcfg), **kw), rows, str(tmp_path / "port"), **run)
    for jf, tf in zip(jfiles, tfiles):
        assert os.path.basename(jf) == os.path.basename(tf)
        jl, tl = ([json.loads(x) for x in open(f)] for f in (jf, tf))
        assert len(tl) == len(jl) and len(tl) >= 4
        for a, b in zip(tl, jl):
            sa, sb = a.pop("score", 0.0), b.pop("score", 0.0)
            assert abs(sa - sb) <= 1e-4 and a == b
