"""PyTorch port vision tower vs `padt_tpu.models.vision.vision_forward` on
the CPU (padt_tiny, float32, tolerance 1e-5 relative to the reference's
magnitude), on both token layouts, and the compact uint8 pixel path."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_common import close, jax_batch, seeded_image, tiny_params, tiny_processor, torch_batch, torch_cfg
from padt_tpu.models import padt as JP
from padt_tpu.models.vision import vision_forward as jax_vision_forward
from padt_tpu.models.vision_geom import vision_geometry
from padt_tpu.preprocess.vision_process import expand_u8_rows
from padt_tpu_torch.models import padt as TP
from padt_tpu_torch.models.vision import vision_forward

GRIDS = [(1, 8, 12), (1, 16, 16)]
T = lambda a: torch.tensor(np.asarray(a))


@pytest.mark.parametrize("slots", [True, False])
def test_vision_forward_matches_jax(slots):
    cfg, jp, tp = tiny_params(0)
    s = cfg.max_image_patches
    geo = vision_geometry(GRIDS, s, window_slots=slots)
    assert (geo.pack_index is not None) == slots
    pix = np.zeros((len(GRIDS), s, cfg.vision.patch_input_dim), np.float32)
    for i, g in enumerate(GRIDS):
        pix[i, : g[1] * g[2]] = seeded_image(g, i, u8=False).pixel_patches
    args = [pix, geo.window_index, geo.inv_window_index, geo.seg_win, geo.seg_full, geo.hpos, geo.wpos]
    jm, jh, (jc, js) = jax_vision_forward(
        jp["vision"], cfg.vision, *map(jnp.asarray, args),
        pack_index=None if geo.pack_index is None else jnp.asarray(geo.pack_index),
    )
    tm, th, (tc, ts) = vision_forward(
        tp["vision"], torch_cfg(cfg).vision, *map(T, args),
        pack_index=None if geo.pack_index is None else T(geo.pack_index),
    )
    for i in range(len(GRIDS)):
        nm, npch = geo.num_merged[i], geo.num_patches[i]
        close(tm[i, :nm], np.asarray(jm)[i, :nm])
        close(th[i, :npch], np.asarray(jh)[i, :npch])
        close(tc[i, :npch], np.asarray(jc)[i, :npch])
        close(ts[i, :npch], np.asarray(js)[i, :npch])


def test_u8_wire_path_matches_f32_rows_and_jax():
    cfg, jp, tp = tiny_params(0)
    tcfg = torch_cfg(cfg)
    proc = tiny_processor(cfg)
    prompts = ['find "x"', 'find "y"']
    b8 = proc.build_batch(prompts, [seeded_image(g, i, u8=True) for i, g in enumerate(GRIDS)], patch_bucket=cfg.max_image_patches)
    bf = proc.build_batch(prompts, [seeded_image(g, i, u8=False) for i, g in enumerate(GRIDS)], patch_bucket=cfg.max_image_patches)
    assert "pixel_patches_u8" in b8.data and "pixel_patches" in bf.data
    # the device-side expansion equals the host rows cast to bf16, exactly
    exp = TP._expand_pixels_u8(tcfg, T(b8.data["pixel_patches_u8"]), T(b8.data["num_patches"]))
    assert torch.equal(exp, T(bf.data["pixel_patches"]).to(torch.bfloat16))
    np.testing.assert_array_equal(
        exp[0, :96].float().numpy(),
        torch.tensor(expand_u8_rows(b8.data["pixel_patches_u8"][0, :96])).to(torch.bfloat16).float().numpy(),
    )
    a8 = TP.run_vision(tp, tcfg, torch_batch(b8.data))
    af = TP.run_vision(tp, tcfg, torch_batch(bf.data))
    assert torch.equal(a8.merged, af.merged) and torch.equal(a8.high_res, af.high_res)
    ja = JP.run_vision(jp, cfg, jax_batch(b8.data))
    for i, g in enumerate(GRIDS):
        nm = g[1] * g[2] // 4
        close(a8.merged[i, :nm], np.asarray(ja.merged)[i, :nm])
        close(a8.proto[i, :nm], np.asarray(ja.proto)[i, :nm])


def test_vision_chunking_is_exact():
    cfg, _, tp = tiny_params(0)
    proc = tiny_processor(cfg)
    grids = GRIDS * 2
    b = proc.build_batch(['a'] * 4, [seeded_image(g, i, u8=True) for i, g in enumerate(grids)], patch_bucket=cfg.max_image_patches)
    tcfg = torch_cfg(cfg)
    whole = TP.run_vision(tp, tcfg, torch_batch(b.data))
    parts = TP.run_vision(tp, tcfg.replace(vision_chunk_size=2), torch_batch(b.data))
    for x, y in zip(whole, parts):
        close(x, y.numpy())
