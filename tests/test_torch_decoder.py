"""PyTorch port perception decoder vs `padt_tpu.models.padt.vl_decode` on
the CPU (padt_tiny, float32, tolerance 1e-5 relative to the reference's
magnitude): boxes, scores and mask-canvas logits of the valid objects."""

import numpy as np

import jax.numpy as jnp
import torch

from test_torch_common import close, tiny_params, torch_cfg
from padt_tpu.models import padt as JP
from padt_tpu.models.vision_geom import vision_geometry
from padt_tpu.ops.rope import vision_rope_cos_sin
from padt_tpu_torch.models import padt as TP

T = lambda a: torch.tensor(np.asarray(a))


def test_vl_decode_matches_jax():
    cfg, jp, tp = tiny_params(2)
    r = np.random.RandomState(3)
    grids = [(1, 8, 12), (1, 16, 16)]
    s, m = cfg.max_image_patches, cfg.max_merged_patches
    geo = vision_geometry(grids, s)
    cos, sin = (np.asarray(x) for x in vision_rope_cos_sin(jnp.asarray(geo.hpos), jnp.asarray(geo.wpos), cfg.vision.head_dim))
    b, n, k = len(grids), 5, cfg.max_vrt_per_object
    art_np = dict(
        merged=r.randn(b, m, cfg.text.hidden_size).astype(np.float32),
        proto=r.randn(b, m, cfg.text.hidden_size).astype(np.float32),
        high_res=r.randn(b, s, cfg.vision.hidden_size).astype(np.float32),
        pe_cos=cos, pe_sin=sin,
        num_merged=geo.num_merged, num_patches=geo.num_patches, grid_thw=geo.grid_thw,
    )
    feats = r.randn(n, k, cfg.text.hidden_size).astype(np.float32)
    counts = np.array([3, 8, 1, 5, 0], np.int32)
    valid = counts > 0
    sample = np.array([0, 1, 1, 0, 0], np.int32)
    canvas = (17, 17)

    jart = JP.VisionArtifacts(**{k_: jnp.asarray(v) for k_, v in art_np.items()})
    tart = TP.VisionArtifacts(**{k_: T(v) for k_, v in art_np.items()})
    jd = JP.vl_decode(jp, cfg, jnp.asarray(feats), jnp.asarray(counts), jnp.asarray(valid), jnp.asarray(sample), jart, canvas_hw=canvas)
    td = TP.vl_decode(tp, torch_cfg(cfg), T(feats), T(counts), T(valid), T(sample), tart, canvas_hw=canvas)
    close(td.pred_boxes, np.asarray(jd.pred_boxes), rows=valid)
    close(td.pred_score, np.asarray(jd.pred_score), rows=valid)
    close(td.pred_mask, np.asarray(jd.pred_mask), rows=valid)
    np.testing.assert_array_equal(td.mask_hw.numpy(), np.asarray(jd.mask_hw))
    # cells outside each object's grid stay empty
    assert torch.all(td.pred_mask[~T(valid)] == 0)
    assert torch.all(td.pred_mask[0, 8 * 4 :] == 0)
