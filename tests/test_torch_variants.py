"""PyTorch port vs the JAX package on the model variants that released
checkpoints exercise (`tests/test_variants.py`'s switches) and on a 2-frame
video (`tests/test_video.py`'s end-to-end setup), on the CPU (padt_tiny,
float32, one random JAX tree bridged to torch by key).

For each switch: greedy `generate` is token-exact (tokens and counts), and
`vl_decode` on the generated hidden states gives boxes, scores and mask
logits within 1e-5 of JAX's, relative to each output's largest value
(float32 on both sides; only the order of sums differs)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_common import close, jax_batch, seeded_image, tiny_processor, torch_batch, torch_cfg
from padt_tpu.config import padt_tiny
from padt_tpu.models import decoder as JD
from padt_tpu.models import padt as JP
from padt_tpu.preprocess.vision_process import ProcessedImage
from padt_tpu_torch.convert.from_jax import params_from_numpy
from padt_tpu_torch.models import decoder as TD
from padt_tpu_torch.models import padt as TP


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side: its tiny-model steps are
    many small ops, which threads only slow down when other test processes
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STEPS = 10
K = 4  # VRT rows of each forced object


def _variant(name):
    cfg = padt_tiny()
    if name == "untied":
        cfg = cfg.replace(text=dataclasses.replace(cfg.text, tie_word_embeddings=False))
    elif name == "no_proto_proj":
        cfg = cfg.replace(use_visual_prototype_projection=False)
    elif name == "no_mask_head":
        cfg = cfg.replace(decoder=dataclasses.replace(cfg.decoder, use_mask_head=False))
    jp = JP.init_padt_params(cfg, jax.random.PRNGKey(7), jnp.float32)
    # larger text-layer weights than the 0.02 init, so the tiny model emits
    # varied tokens instead of one token repeated
    jp["text"]["layers"] = jax.tree.map(lambda x: x * 5.0 if x.ndim == 3 else x, jp["text"]["layers"])
    if name == "untied":
        jp["text"]["lm_head"] = jp["text"]["lm_head"] * 5.0
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _generate_both(cfg, jp, tp, imgs, prompts, **kw):
    jproc, tproc = tiny_processor(cfg), tiny_processor(torch_cfg(cfg))
    jbatch = jproc.build_batch(prompts, imgs, patch_bucket=cfg.max_image_patches, **kw)
    tbatch = tproc.build_batch(prompts, [_port(i) for i in imgs], patch_bucket=cfg.max_image_patches, **kw)
    for k, v in jbatch.data.items():
        np.testing.assert_array_equal(np.asarray(tbatch.data[k]), np.asarray(v), err_msg=k)
    jo = JP.generate(jp, cfg, jax_batch(jbatch.data), STEPS, jnp.asarray(jbatch.rope_deltas), eos_token_id=-1)
    to = TP.generate(tp, torch_cfg(cfg), torch_batch(tbatch.data), STEPS, torch.as_tensor(tbatch.rope_deltas),
                     eos_token_id=-1)
    np.testing.assert_array_equal(to.tokens.numpy(), np.asarray(jo.tokens))
    np.testing.assert_array_equal(to.num_generated.numpy(), np.asarray(jo.num_generated))
    close(to.hidden, np.asarray(jo.hidden), tol=1e-4)
    return jbatch, jo, to


def _port(img):
    from test_torch_common import port_image

    return port_image(img)


@pytest.mark.parametrize("name", ["untied", "no_proto_proj", "zero_init_proto", "no_mask_head", "mask_canvas"])
def test_variant_generate_and_decode_match_jax(name):
    cfg, jp, tp = _variant(name)
    imgs = [seeded_image((1, 8, 12), 11, u8=False), seeded_image((1, 12, 16), 12, u8=False)]
    _, jo, to = _generate_both(cfg, jp, tp, imgs, ['find "x"', 'where is "the cat"'])
    assert len(set(to.tokens.flatten().tolist())) > 2, to.tokens

    # vl_decode on forced objects: the first K generated hidden rows of each sample
    n = cfg.max_objects
    feats = np.zeros((n, cfg.max_vrt_per_object, cfg.text.hidden_size), np.float32)
    feats[:2, :K] = np.asarray(jo.hidden)[:, :K]
    counts = np.array([K, K] + [0] * (n - 2), np.int32)
    valid, sample = counts > 0, np.array([0, 1] + [0] * (n - 2), np.int32)
    canvas = (9, 13) if name == "mask_canvas" else None
    jd = JP.vl_decode(jp, cfg, jnp.asarray(feats), jnp.asarray(counts), jnp.asarray(valid), jnp.asarray(sample),
                      jo.artifacts, canvas_hw=canvas)
    td = TP.vl_decode(tp, torch_cfg(cfg), torch.as_tensor(feats), torch.as_tensor(counts), torch.as_tensor(valid),
                      torch.as_tensor(sample), to.artifacts, canvas_hw=canvas)
    close(td.pred_boxes, np.asarray(jd.pred_boxes), rows=valid)
    close(td.pred_score, np.asarray(jd.pred_score), rows=valid)
    close(td.pred_mask, np.asarray(jd.pred_mask), rows=valid)
    np.testing.assert_array_equal(td.mask_hw.numpy(), np.asarray(jd.mask_hw))

    if name == "untied":
        assert "lm_head" in tp["text"] and tp["text"]["lm_head"].shape == tp["text"]["embed"].shape
        tied = to.hidden @ tp["text"]["embed"].t()
        untied = to.hidden @ tp["text"]["lm_head"].t()
        assert not torch.allclose(tied, untied)
    elif name == "no_proto_proj":
        assert "proto" not in tp
        assert torch.equal(to.artifacts.proto, to.artifacts.merged)
    elif name == "zero_init_proto":
        # ZeroInitLayerNorm: weight and bias zero, so every prototype is 0
        assert torch.all(tp["proto"]["ln_w"] == 0) and torch.all(tp["proto"]["ln_b"] == 0)
        assert torch.all(to.artifacts.proto == 0) and np.all(np.asarray(jo.artifacts.proto) == 0)
    elif name == "no_mask_head":
        assert torch.all(td.pred_mask == 0) and float(jnp.abs(jd.pred_mask).sum()) == 0.0
    else:
        assert tuple(td.pred_mask.shape) == (n, 4 * 9, 4 * 13)


def test_mask_canvas_geometry_matches_jax():
    """`assemble_mask_canvas` on `tests/test_variants.py`'s layout (token p's
    4x4 block at raster cell (p // W, p % W), out-of-range tokens dropped):
    the same canvas on both sides, exactly (a scatter of the same values)."""
    n, s = 2, 12
    sub = np.arange(16, dtype=np.float32).reshape(4, 4)
    logit = np.zeros((n, s, 4, 4), np.float32)
    logit[0, 5] = sub
    logit[1, 7] = 2 * sub
    logit[1, 10] = 99.0  # past object 1's 9 tokens
    args = (np.array([4, 3]), np.array([12, 9]), np.array([True, True]))
    j = np.asarray(JD.assemble_mask_canvas(jnp.asarray(logit), *map(jnp.asarray, args), canvas_hw=(4, 4)))
    t = TD.assemble_mask_canvas(torch.as_tensor(logit), *map(torch.as_tensor, args), canvas_hw=(4, 4)).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[0, 4:8, 4:8], sub)
    assert float(np.abs(t[1]).sum()) == float(np.abs(2 * sub).sum())


def test_video_generate_is_token_exact():
    """`tests/test_video.py`'s 2-frame video batch (grid (2, 8, 12), one
    second per temporal grid step) through greedy `generate`: the same
    batch (video pad tokens spliced, time-aligned M-RoPE positions), tokens
    and counts equal to JAX's; the image run of the same pixels has other
    positions on both sides."""
    cfg = padt_tiny()
    jp = JP.init_padt_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    jp["text"]["layers"] = jax.tree.map(lambda x: x * 5.0 if x.ndim == 3 else x, jp["text"]["layers"])
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    pix = np.random.RandomState(0).randn(192, 1176).astype(np.float32)
    vid = ProcessedImage(pixel_patches=pix, grid_thw=(2, 8, 12), second_per_grid_t=1.0, is_video=True)
    img = ProcessedImage(pixel_patches=pix.copy(), grid_thw=(2, 8, 12))
    pos = {}
    for name, p in (("video", vid), ("image", img)):
        jbatch, _, to = _generate_both(cfg, jp, tp, [p], ["what happens"], prompt_bucket=128)
        want = cfg.video_token_id if name == "video" else cfg.image_token_id
        assert int((jbatch.data["input_ids"][0] == want).sum()) == 48
        assert torch.isfinite(to.hidden).all()
        pos[name] = np.asarray(jbatch.data["position_ids"])
    assert not np.array_equal(pos["video"], pos["image"])
